"""Property tests for the LWE-level LEV/GSW algebra (ciphertext/lev.py) and
the RGSW homomorphic add/sub (ciphertext/gsw.py) -- paths the reference
ships broken and never calls (gsw.jl:131-155 / :186-210 reference a
nonexistent `x.basket` and would throw); here they must actually work."""

import jax
import jax.numpy as jnp
import numpy as np

from mktfhe.ciphertext.gsw import (
    external_product_hat,
    rgsw_add,
    rgsw_encrypt,
    rgsw_sub,
    rgsw_to_hat,
    rlwe_decomp_hat,
)
from mktfhe.ciphertext.keys import binary_lwe_key, binary_ring_key
from mktfhe.ciphertext.lev import (
    Lev,
    gsw_add,
    gsw_encrypt,
    gsw_sub,
    lev_add,
    lev_encrypt,
    lev_ith_encrypt,
    lev_sub,
)
from mktfhe.ciphertext.lwe import Lwe, phase
from mktfhe.ciphertext.rlwe import (
    gadget_gvec,
    rlwe_encrypt_msg,
    rlwe_phase,
)
from mktfhe.ring import from_crt, inv_ntt
from mktfhe.ring.context import make_ring_ctx

L, LOG_B = 3, 8


def _lev_err(ct: Lev, key, m):
    """|phase(row j) - m*g_j| as signed ints."""
    gvec = np.asarray(gadget_gvec(L, LOG_B, key.key.dtype))
    ph = np.asarray(phase(Lwe(b=ct.b, a=ct.a), key))
    return (ph - np.uint32(m) * gvec).astype(np.int32)


def test_lev_encrypt_rows_carry_gadget():
    key = binary_lwe_key(jax.random.key(0), 64, jnp.uint32)
    m = 3 << 20
    ct = lev_encrypt(jax.random.key(1), m, key, 16.0, L, LOG_B)
    assert ct.b.shape == (L,) and ct.a.shape == (L, 64)
    assert np.all(np.abs(_lev_err(ct, key, m)) < 2000)


def test_lev_ith_encrypt_adds_on_coeff():
    """lev.jl:39-45: m*g_j is added to a_i, so the phase carries m*g_j*s_i."""
    key = binary_lwe_key(jax.random.key(0), 32, jnp.uint32)
    m, i = 5 << 18, 2
    ct = lev_ith_encrypt(jax.random.key(1), m, i, key, 16.0, L, LOG_B)
    s_i = int(np.asarray(key.key)[i])
    assert np.all(np.abs(_lev_err(ct, key, m * s_i)) < 2000)


def test_lev_add_sub_homomorphic():
    key = binary_lwe_key(jax.random.key(0), 64, jnp.uint32)
    m1, m2 = 7 << 19, 3 << 19
    c1 = lev_encrypt(jax.random.key(1), m1, key, 16.0, L, LOG_B)
    c2 = lev_encrypt(jax.random.key(2), m2, key, 16.0, L, LOG_B)
    assert np.all(np.abs(_lev_err(lev_add(c1, c2), key, m1 + m2)) < 4000)
    assert np.all(np.abs(_lev_err(lev_sub(c1, c2), key, m1 - m2)) < 4000)


def test_gsw_add_sub_homomorphic():
    """GSW rows stay consistent under add/sub: the b-basket decrypts to
    (m1 +- m2)*g_j and each a-basket row i to (m1 +- m2)*g_j*s_i... which
    for an encryption-of-zero-structured check reduces to phase tests on
    the b rows (index 0)."""
    n = 32
    key = binary_lwe_key(jax.random.key(0), n, jnp.uint32)
    m1, m2 = 9 << 18, 5 << 18
    g1 = gsw_encrypt(jax.random.key(1), m1, key, 16.0, L, LOG_B)
    g2 = gsw_encrypt(jax.random.key(2), m2, key, 16.0, L, LOG_B)
    assert g1.b.shape == (n + 1, L) and g1.a.shape == (n + 1, L, n)
    for op, want in [(gsw_add, m1 + m2), (gsw_sub, m1 - m2)]:
        out = op(g1, g2)
        berr = _lev_err(Lev(b=out.b[0], a=out.a[0]), key, want)
        assert np.all(np.abs(berr) < 4000), op.__name__


def test_rgsw_add_sub_homomorphic():
    """external_product(rgsw_add(G1,G2), ct) == external_product under
    message m1+m2 (up to noise): check via RLWE phase of the product."""
    ctx = make_ring_ctx(64, 32)
    key = binary_ring_key(jax.random.key(0), 1, ctx)
    one = jnp.array(1, ctx.dtype)
    g1 = rgsw_encrypt(jax.random.key(1), one, key, 4.0, L, LOG_B, ctx)
    g2 = rgsw_encrypt(jax.random.key(2), one, key, 4.0, L, LOG_B, ctx)
    m = jnp.zeros((64,), ctx.dtype).at[0].set(jnp.array(1, ctx.dtype) << 29)
    ct = rlwe_encrypt_msg(jax.random.key(3), m, 0, key, 4.0, ctx)

    for op, scale in [(rgsw_add, 2), (rgsw_sub, 0)]:
        hat, hat_sh = rgsw_to_hat(op(g1, g2), ctx)
        dhat = rlwe_decomp_hat(ct, L, LOG_B, ctx)
        prod = from_crt(inv_ntt(external_product_hat(dhat, hat, hat_sh, ctx), ctx.plan), ctx.crt, ctx.dtype)
        ph = np.asarray(rlwe_phase(prod, key, ctx)).astype(np.int64)
        want = int(scale) << 29
        err = (ph - np.where(np.arange(64) == 0, want, 0)) % (1 << 32)
        err = np.where(err >= 1 << 31, err - (1 << 32), err)
        assert np.all(np.abs(err) < 1 << 22), op.__name__
