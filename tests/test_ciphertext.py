"""L1 tests: LWE/RLWE round trips, gadget decomposition, external product.

Property tests the reference lacks entirely (SURVEY.md section 4): the
reference's only correctness check is end-to-end gate trials.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe.ciphertext import (
    balanced_decomp,
    binary_lwe_key,
    binary_ring_key,
    external_product_hat,
    lwe_encrypt,
    phase,
    rgsw_encrypt,
    rgsw_to_hat,
    rlwe_decomp_hat,
    rlwe_encrypt_msg,
    rlwe_phase,
    unbalanced_decomp,
)
from mktfhe.ring import from_crt, inv_ntt
from mktfhe.ring.context import make_ring_ctx


def _signed(x):
    t = x.dtype.itemsize * 8
    return x.astype(np.int64) if t == 32 else x.astype(np.object_) - np.where(
        x.astype(np.object_) >= 1 << 63, 1 << 64, 0
    )


def test_lwe_roundtrip():
    key = binary_lwe_key(jax.random.key(0), 64, jnp.uint32)
    msgs = jnp.array([0, 1 << 29, 3 << 29], dtype=jnp.uint32)
    ct = lwe_encrypt(jax.random.key(1), msgs, key, 16.0, shape=(3,))
    err = np.asarray(phase(ct, key) - msgs).astype(np.int32)
    assert np.all(np.abs(err) < 2000)


@pytest.mark.parametrize("torus_bits", [32, 64])
def test_rlwe_roundtrip(torus_bits):
    ctx = make_ring_ctx(64, torus_bits)
    key = binary_ring_key(jax.random.key(0), 2, ctx)
    m = jnp.zeros((64,), ctx.dtype).at[0].set(
        jnp.array(1, ctx.dtype) << (torus_bits - 3)
    )
    ct = rlwe_encrypt_msg(jax.random.key(1), m, 0, key, 4.0, ctx)
    err = np.asarray(rlwe_phase(ct, key, ctx) - m)
    err = np.minimum(err, (0 - err).astype(err.dtype))  # |err| wrapped
    assert np.all(err.astype(np.float64) < 2000)


@pytest.mark.parametrize("dtype,l,log_b", [(jnp.uint32, 3, 8), (jnp.uint64, 4, 9)])
def test_balanced_decomp_identity(dtype, l, log_b):
    t = jnp.dtype(dtype).itemsize * 8
    rng = np.random.default_rng(1)
    a = jnp.array(
        rng.integers(0, 1 << 32, size=256, dtype=np.uint64).astype(jnp.dtype(dtype).type)
    )
    if t == 64:
        a = a | (jnp.array(rng.integers(0, 1 << 32, size=256, dtype=np.uint64)) << 32)
    d = np.asarray(balanced_decomp(a, l, log_b))  # [256, l] int32
    assert np.all(np.abs(d.astype(np.int64)) <= 1 << (log_b - 1))
    low = t - l * log_b
    ai = np.asarray(a).astype(np.object_)
    rounded = ((ai >> low) + ((ai >> (low - 1)) & 1)) if low > 0 else ai
    recon = sum(
        d[:, j].astype(np.object_) * (1 << ((l - 1 - j) * log_b)) for j in range(l)
    )
    assert np.all((recon - rounded) % (1 << (l * log_b)) == 0)


def test_unbalanced_decomp_identity():
    rng = np.random.default_rng(2)
    a = jnp.array(rng.integers(0, 1 << 32, size=256, dtype=np.uint32))
    l, log_b = 8, 2
    d = np.asarray(unbalanced_decomp(a, l, log_b))
    assert np.all((d >= 0) & (d < 1 << log_b))
    low = 32 - l * log_b
    ai = np.asarray(a).astype(np.object_)
    rounded = ((ai >> low) + ((ai >> (low - 1)) & 1)) if low > 0 else ai
    recon = sum(
        d[:, j].astype(np.object_) * (1 << ((l - 1 - j) * log_b)) for j in range(l)
    )
    assert np.all((recon - rounded) % (1 << (l * log_b)) == 0)


@pytest.mark.parametrize("torus_bits", [32, 64])
def test_external_product_selects(torus_bits):
    """ExtProd(G^{-1}(ct), RGSW(m)) ~ m * ct for m in {0, 1} (the CMux core,
    bootstrapping.jl:62-68)."""
    n, l, log_b = 64, 3, 8
    ctx = make_ring_ctx(n, torus_bits)
    key = binary_ring_key(jax.random.key(0), 1, ctx)
    t = torus_bits
    m = jnp.zeros((n,), ctx.dtype).at[3].set(jnp.array(1, ctx.dtype) << (t - 3))
    ct = rlwe_encrypt_msg(jax.random.key(1), m, 0, key, 4.0, ctx)

    for bit, want in [(0, jnp.zeros((n,), ctx.dtype)), (1, m)]:
        g = rgsw_encrypt(
            jax.random.key(2), jnp.array(bit, ctx.dtype), key, 4.0, l, log_b, ctx
        )
        g_hat, g_shoup = rgsw_to_hat(g, ctx)
        dhat = rlwe_decomp_hat(ct, l, log_b, ctx)
        out_hat = external_product_hat(dhat, g_hat, g_shoup, ctx)
        out = from_crt(inv_ntt(out_hat, ctx.plan), ctx.crt, ctx.dtype)
        ph = np.asarray(rlwe_phase(out, key, ctx) - want)
        ph = np.minimum(ph, (0 - ph).astype(ph.dtype))
        # noise: decomposition error ~ 2^(t - l*logB) plus key noise
        assert np.all(ph.astype(np.float64) < 2 ** (t - l * log_b + 8))
