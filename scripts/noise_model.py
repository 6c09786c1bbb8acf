"""Analytic noise model for the CCS hybrid-product bootstrap.

Predicts the output phase-error stddev of one NAND bootstrap per CCS
preset from the scheme algebra alone (no simulation), for comparison with
the measured margins (margins.json).  Derivation (NOISE.md): the phase
error of one hybrid product of the accumulator c (components 0..idx) with
party t's UniEnc(mu) is

    err = <y, e_d> + r * sum_i <y_i, e_b,i> + r * eps_v + <g^-1(v), e_f>

with y = g^-1(c) (balanced digits, E[y^2] = B^2/12), r the ternary
ephemeral key (E[r^2] = 2/3; a product by r multiplies a variance by
2N/3), e_* fresh gaussians of stddev beta, and eps_v the gadget
approximation error (uniform over 2^(T - l*logB), T = 32).  The monomial
(X^a - 1) doubles each step's variance; the blind rotation adds k*n such
terms (party idx processes n steps at accumulator width idx+1).

The r * <y, e_b> term dominates at the reference's k=2/4 gadgets
(l*B^2 = 196608); the *Tight presets shrink exactly this product.

Usage: python scripts/noise_model.py   (prints one JSON line per preset)
"""

import json
import math
import sys

sys.path.insert(0, ".")

from mktfhe.schemes.presets import ALL_PRESETS  # noqa: E402


def ccs_predicted_std_bits(params) -> dict:
    n, big_n, k = params.n, params.big_n, params.k
    l, log_b = params.l_uni, params.log_b_uni
    b2_12 = (1 << (2 * log_b)) / 12.0  # E[digit^2]
    beta2 = params.beta**2
    rfac = 2.0 * big_n / 3.0  # variance factor of a product by ternary r
    eps2 = (2.0 ** (2 * (32 - l * log_b))) / 12.0  # gadget approx error

    var_br = 0.0
    for idx in range(1, k + 1):
        t1 = (idx + 1) * l * big_n * b2_12 * beta2  # <y, e_d>
        t2 = rfac * idx * l * big_n * b2_12 * beta2  # r * <y, e_b>
        t3 = rfac * (idx + 1) * big_n * eps2  # r * eps_v
        t4 = (idx + 1) * l * big_n * b2_12 * beta2  # <g^-1(v), e_f>
        var_br += 2.0 * n * (t1 + t2 + t3 + t4)  # x2: monomial (X^a - 1)

    # key switch: one fresh alpha-noise unit per nonzero balanced digit
    # (signed value-table ksk, schemes/common.py); digits are ~3/4 nonzero
    # at log_d=2.  Plus the 2N modulus-switch rounding on k*n+1 terms.
    var_ks = k * big_n * params.f * 0.75 * params.alpha**2
    var_ms = (k * n / 4.0 + 1) * (2.0 ** (2 * (32 - 1 - math.log2(big_n)))) / 12.0

    var = var_br + var_ks + var_ms
    std_bits = 0.5 * math.log2(var)
    margin_sigma = (1 << 28) / math.sqrt(var)  # |err| < 2^28 = 1/16 torus
    return {
        "preset_k": k,
        "l_uni": l,
        "log_b_uni": log_b,
        "pred_std_bits": round(std_bits, 2),
        "pred_margin_sigmas": round(margin_sigma, 1),
        "br_share": round(var_br / var, 3),
        "ks_share": round(var_ks / var, 3),
    }


def main():
    for name, p in ALL_PRESETS.items():
        if not name.startswith("CCS"):
            continue
        rec = {"preset": name, **ccs_predicted_std_bits(p)}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
