"""Set-up shared by the GPU entry points (chip_smoke.py, bench.py,
scripts/ntt_kernel_bench.py): the device check, the card's name, and KMS
keys with a NAND ciphertext pair."""

from __future__ import annotations

import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np


def require_gpu(n_cards: int = 1, who: str = "mktfhe"):
    """The first n_cards JAX devices, which must be GPUs; never the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"{who}: JAX found no GPU (default platform {devs[0].platform!r})")
    if len(devs) < n_cards:
        raise SystemExit(f"{who}: need {n_cards} GPUs, JAX sees {len(devs)}")
    return devs[:n_cards]


def card_names() -> list[str]:
    """nvidia-smi's name and power limit, one entry per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def kms_nand_inputs(params, batch: int, seed: int = 0):
    """KMS keys (generated once, on the default device) and the two inputs
    of a NAND gate: parties 0 and 1 each encrypt `batch` random bits.

    Returns (scheme, lwe_keys, c1, c2, m1, m2, keygen_s)."""
    from ..schemes import kms
    from ..schemes.gates import lwe_ith_encrypt_bit

    t0 = time.perf_counter()
    root = jax.random.key(seed)
    crs = kms.crs(jax.random.fold_in(root, 1), params)
    parties = [
        kms.party_keygen(jax.random.fold_in(root, 100 + i), crs, params)
        for i in range(params.k)
    ]
    lwe_keys = [p[0] for p in parties]
    scheme = kms.setup(crs, [p[3] for p in parties], params)
    jax.block_until_ready(scheme)
    keygen_s = time.perf_counter() - t0
    del parties
    m1, m2 = np.random.default_rng(seed).integers(0, 2, (2, batch)).astype(bool)
    c1, c2 = (
        lwe_ith_encrypt_bit(
            jax.random.fold_in(root, 2 + i), jnp.asarray(m), i, lwe_keys[i],
            params.alpha, params.k, (batch,),
        )
        for i, m in enumerate((m1, m2))
    )
    return scheme, lwe_keys, c1, c2, m1, m2, keygen_s
