"""Benchmark: gate bootstraps/s on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "device"}; the
card's name and power limit, keygen time and the decrypt check go to stderr.

Timing: the output is decrypt-checked once, then a chain of data-dependent
bootstraps (each consuming the previous output, a real homomorphic gate
chain) is timed, ending in jax.block_until_ready.

Usage: python bench.py [scheme] [batch]
  scheme: cggi | kms{k}[block][-pl]   (default kms8block: KMS8partyblock,
          the reference's own fast k=8 variant, on the jnp path; -pl runs
          every NTT through the Pallas kernel, pallas_ntt=True)
  batch:  gates per bootstrap call (default 256 for cggi, else 128)
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from mktfhe.utils.harness import card_names, kms_nand_inputs, require_gpu


def _time_bootstraps(boot, chain_step, first_ct, reps=8):
    """Time a dependent chain: ct -> boot -> chain_step -> boot -> ..."""
    out = jax.block_until_ready(boot(first_ct))  # compile + warm
    t0 = time.perf_counter()
    cur = out
    for _ in range(reps):
        cur = boot(chain_step(cur))
    jax.block_until_ready(cur)
    return (time.perf_counter() - t0) / reps, out


def main():
    scheme_name = sys.argv[1] if len(sys.argv) > 1 else "kms8block"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else (256 if scheme_name == "cggi" else 128)
    [dev] = require_gpu(1, "bench.py")
    card = card_names()[0]
    print(f"# gpu: {card}", file=sys.stderr)

    from mktfhe.schemes.gates import gate_affine, lwe_decrypt_bit, lwe_decrypt_bit_mk, lwe_encrypt_bit

    if scheme_name == "cggi":
        from mktfhe.schemes import cggi as mod
        from mktfhe.schemes.presets import CGGI_PARAM as params

        t0 = time.perf_counter()
        lwe_key, _r, scheme = mod.setup(jax.random.key(0), params)
        jax.block_until_ready(scheme)
        keygen_s = time.perf_counter() - t0
        m1, m2 = np.random.default_rng(0).integers(0, 2, (2, batch)).astype(bool)
        c1 = lwe_encrypt_bit(jax.random.key(1), jnp.array(m1), lwe_key, params.alpha, (batch,))
        ct2 = lwe_encrypt_bit(jax.random.key(2), jnp.array(m2), lwe_key, params.alpha, (batch,))
        decrypt = lambda out: lwe_decrypt_bit(out, lwe_key)
    elif scheme_name.startswith("kms"):
        from mktfhe.schemes import kms as mod
        from mktfhe.schemes.presets import ALL_PRESETS

        kstr = scheme_name[3:].removesuffix("-pl")
        block = kstr.endswith("block")
        k = int(kstr[:-5] if block else kstr)
        params = ALL_PRESETS[f"KMS{k}party" + ("block" if block else "")]
        scheme, lwe_keys, c1, ct2, m1, m2, keygen_s = kms_nand_inputs(params, batch)
        decrypt = lambda out: lwe_decrypt_bit_mk(out, lwe_keys)
    else:
        raise SystemExit(f"unknown scheme {scheme_name}")
    pallas = {"pallas_ntt": True} if scheme_name.endswith("-pl") else {}
    boot = lambda ct: mod.bootstrap(ct, scheme, params, **pallas)
    chain_step = lambda prev: gate_affine(0, prev, ct2)

    dt, out = _time_bootstraps(boot, chain_step, gate_affine(0, c1, ct2))
    ok = bool(np.array_equal(np.asarray(decrypt(out)), ~(m1 & m2)))

    value = batch / dt
    print(
        f"# {scheme_name} keygen {keygen_s:.1f}s, steady {dt*1e3:.1f}ms/batch-{batch} "
        f"({dt/batch*1e3:.3f} ms/gate), decrypt {'OK' if ok else 'MISMATCH'} [{card}]",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": f"{scheme_name.replace('-', '_')}_gate_bootstraps_per_sec",
                "value": value,
                "unit": "bootstraps/s",
                "device": {"platform": dev.platform, "kind": dev.device_kind, "count": 1},
            }
        )
    )
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
