"""Noise-source attribution for a preset: run bootstraps with selected
noise stddevs zeroed to decompose the output phase-error variance.

Because this framework's arithmetic is exact, phase error with alpha=0 and
beta=0 is pure decomposition/rounding error; alpha-only adds key-switch
noise; beta-only adds blind-rotation encryption noise.

Usage: python scripts/noise_attrib.py <preset> [batch]
"""

import dataclasses
import json
import sys
import time

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
from mktfhe.schemes.params import BlockParams, CcsParams, CggiParams
from mktfhe.schemes.presets import ALL_PRESETS
from mktfhe.utils.noise import noise_report


def run(name, params, batch):
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
        out = mod.bootstrap(gate_affine(0, ct1, ct2), scheme, params)
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
        out = mod.bootstrap(gate_affine(0, ct1, ct2), scheme, params)
    rep = noise_report(out, keys, want)
    return rep


def main():
    name = sys.argv[1]
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    base = ALL_PRESETS[name]
    for tag, repl in [
        ("full", {}),
        ("beta=0 (ksk+rounding only)", {"beta": 0.0}),
        ("alpha=0 (BR+rounding only)", {"alpha": 0.0}),
        ("alpha=beta=0 (rounding only)", {"alpha": 0.0, "beta": 0.0}),
    ]:
        params = dataclasses.replace(base, **repl)
        t0 = time.time()
        rep = run(name, params, batch)
        print(
            json.dumps(
                {
                    "preset": name,
                    "case": tag,
                    "std_bits": round(rep["std_bits"], 2),
                    "margin_sigmas": round(rep["margin_sigmas"], 1),
                    "s": round(time.time() - t0, 1),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
