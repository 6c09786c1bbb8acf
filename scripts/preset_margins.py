"""Full-dimension correctness + noise-margin trials for every preset.

Runs one NAND-gate bootstrap per preset at the preset's real parameters
(reference semantics: /root/reference/test/KMS.jl:20-37 runs every scheme
at full dimensions), asserts decryption against the cleartext oracle, and
records the empirical noise margin (utils/noise.py).  Appends results to
margins.json and regenerates MARGINS.md.

Usage: python scripts/preset_margins.py [preset ...]     (default: all)
"""

import gc
import json
import os
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from mktfhe.schemes import ccs, cggi, kms, lmss
from mktfhe.schemes.gates import (
    gate_affine,
    lwe_decrypt_bit,
    lwe_decrypt_bit_mk,
    lwe_encrypt_bit,
    lwe_ith_encrypt_bit,
)
from mktfhe.schemes.params import CcsParams, CggiParams, BlockParams
from mktfhe.schemes.presets import ALL_PRESETS
from mktfhe.utils.noise import noise_report


def run_preset(name: str, batch: int = 16) -> dict:
    params = ALL_PRESETS[name]
    rng = np.random.default_rng(7)
    m1 = rng.integers(0, 2, batch).astype(bool)
    m2 = rng.integers(0, 2, batch).astype(bool)
    want = ~(m1 & m2)
    if isinstance(params, (CggiParams, BlockParams)):
        mod = cggi if isinstance(params, CggiParams) else lmss
        lwe_key, _rk, scheme = mod.setup(jax.random.key(0), params)
        keys = [lwe_key]
        ct1 = lwe_encrypt_bit(jax.random.key(1), jnp.array(m1), lwe_key, params.alpha, (batch,))
        ct2 = lwe_encrypt_bit(jax.random.key(2), jnp.array(m2), lwe_key, params.alpha, (batch,))
        boot = lambda ct: mod.bootstrap(ct, scheme, params)
        decrypt = lambda o: lwe_decrypt_bit(o, keys[0])
    else:
        mod = ccs if isinstance(params, CcsParams) else kms
        k = params.k
        a = mod.crs(jax.random.key(0), params)
        parties = [mod.party_keygen(jax.random.key(1 + i), a, params) for i in range(k)]
        keys = [p[0] for p in parties]
        if mod is ccs:
            scheme = mod.setup(a, [p[2] for p in parties], params)
        else:
            scheme = mod.setup(a, [p[3] for p in parties], params)
        ct1 = lwe_ith_encrypt_bit(jax.random.key(101), jnp.array(m1), 0, keys[0], params.alpha, k, (batch,))
        ct2 = lwe_ith_encrypt_bit(jax.random.key(102), jnp.array(m2), 1, keys[1], params.alpha, k, (batch,))
        boot = lambda ct: mod.bootstrap(ct, scheme, params)
        decrypt = lambda o: lwe_decrypt_bit_mk(o, keys)
    out = boot(gate_affine(0, ct1, ct2))
    got = np.asarray(decrypt(out))
    ok = bool(np.array_equal(got, want))
    rep = noise_report(out, keys, want)
    rec = {
        "preset": name,
        "batch": batch,
        "decrypt_ok": ok,
        "std_bits": round(rep["std_bits"], 2),
        "max_abs_bits": round(rep["max_abs_bits"], 2),
        "margin_bits": rep["margin_bits"],
        "margin_sigmas": round(rep["margin_sigmas"], 1),
    }
    print(json.dumps(rec), flush=True)
    return rec


def write_md(rows: dict):
    lines = [
        "# MARGINS — full-dimension preset validation",
        "",
        "One NAND bootstrap per preset at real parameters,",
        "decrypt checked against the cleartext oracle, noise margin measured",
        "empirically (`mktfhe/utils/noise.py`). `margin_sigmas > 6` means",
        "per-gate error probability below ~1e-9. Generated by",
        "`scripts/preset_margins.py`; raw data in `margins.json`.",
        "",
        "Exact integer arithmetic: the margins do not depend on the device.",
        "",
        "Note. The sub-6σ CCS2/4party rows reproduce the reference's own",
        "pipeline behavior: a numpy emulation of its Float64-FFT path",
        "measures 1.98σ/1.67σ at the same presets (NOISE.md,",
        "scripts/ccs_ref_emulation.py) — the published parameters are",
        "inherently marginal; the CCS*Tight presets are the remedy.",
        "",
        "| preset | batch | decrypt | noise std (bits) | margin (bits) | margin/sigma |",
        "|---|---|---|---|---|---|",
    ]
    for name in (n for n in ALL_PRESETS if not n.startswith("Tiny")):
        r = rows.get(name)
        if r is None:
            lines.append(f"| {name} | — | not run | — | — | — |")
        elif "error" in r:
            lines.append(f"| {name} | — | ERROR | — | — | {r['error'][:60]} |")
        else:
            lines.append(
                f"| {name} | {r['batch']} | {'ok' if r['decrypt_ok'] else 'FAIL'} | "
                f"{r['std_bits']} | {r['margin_bits']} | {r['margin_sigmas']} |"
            )
    lines.append("")
    with open("MARGINS.md", "w") as f:
        f.write("\n".join(lines))


def main():
    names = sys.argv[1:] or [n for n in ALL_PRESETS if not n.startswith("Tiny")]
    rows = {}
    if os.path.exists("margins.json"):
        with open("margins.json") as f:
            rows = {r["preset"]: r for r in json.load(f)}
    for name in names:
        # optional per-preset batch override: "CGGI:64"
        if ":" in name:
            name, bstr = name.split(":")
            batch = int(bstr)
        else:
            batch = 8 if "16" in name or "32" in name else 16
        try:
            rows[name] = run_preset(name, batch=batch)
        except Exception as e:
            rows[name] = {"preset": name, "error": repr(e)[:300]}
            print(json.dumps(rows[name]), flush=True)
        gc.collect()
    with open("margins.json", "w") as f:
        json.dump([rows[n] for n in ALL_PRESETS if n in rows], f, indent=1)
    write_md(rows)


if __name__ == "__main__":
    main()
