"""End-to-end LMSS (block-binary) gate tests (reference test/LMSS.jl)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe.schemes import lmss
from mktfhe.schemes.gates import (
    CLEAR_OPS,
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit,
    lwe_encrypt_bit,
)
from mktfhe.schemes.params import BlockParams

TINY = BlockParams(
    d=8, ell=2, alpha=16.0, f=8, log_d=2, big_n=64, k=1, beta=16.0,
    l_gsw=3, log_b_gsw=8,
)


@pytest.fixture(scope="module")
def tiny_scheme():
    return lmss.setup(jax.random.key(11), TINY)


def test_all_gates_batched(tiny_scheme):
    lwe_key, _ring_key, scheme = tiny_scheme
    ops = list(GATE_IDS)
    g = len(ops)
    rng = np.random.default_rng(4)
    m1 = rng.integers(0, 2, size=g).astype(bool)
    m2 = rng.integers(0, 2, size=g).astype(bool)
    ct1 = lwe_encrypt_bit(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = lwe_encrypt_bit(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    op_ids = jnp.array([GATE_IDS[o] for o in ops], dtype=jnp.int32)

    out = lmss.bootstrap(gate_affine(op_ids, ct1, ct2), scheme, TINY)
    got = np.asarray(lwe_decrypt_bit(out, lwe_key))
    want = np.array([CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)])
    np.testing.assert_array_equal(got, want)


def test_lmss_pallas_ntt_bit_identical(tiny_scheme):
    import numpy as np

    lwe_key, _rk, scheme = tiny_scheme
    g = 4
    rng = np.random.default_rng(3)
    m1 = rng.integers(0, 2, g).astype(bool)
    m2 = rng.integers(0, 2, g).astype(bool)
    ct1 = lwe_encrypt_bit(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = lwe_encrypt_bit(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    ct = gate_affine(0, ct1, ct2)
    ref = lmss.bootstrap(ct, scheme, TINY)
    got = lmss.bootstrap(ct, scheme, TINY, pallas_ntt=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(ref.a))
