"""End-to-end CCS multi-key gate tests (reference test/CCS.jl semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe.schemes import ccs
from mktfhe.schemes.gates import (
    CLEAR_OPS,
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit_mk,
    lwe_ith_encrypt_bit,
)
from mktfhe.schemes.params import CcsParams

TINY = CcsParams(
    n=8, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0, l_uni=3, log_b_uni=8, k=2
)

TINY4 = CcsParams(
    n=8, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0, l_uni=3, log_b_uni=8, k=4
)


@pytest.fixture(scope="module")
def tiny_mk():
    a = ccs.crs(jax.random.key(100), TINY)
    parties = [
        ccs.party_keygen(jax.random.key(200 + i), a, TINY) for i in range(TINY.k)
    ]
    lwe_keys = [p[0] for p in parties]
    scheme = ccs.setup(a, [p[2] for p in parties], TINY)
    return lwe_keys, scheme


def test_mk_gates(tiny_mk):
    lwe_keys, scheme = tiny_mk
    rng = np.random.default_rng(9)
    ops = ["NAND", "AND", "OR", "XOR"]
    g = len(ops)
    m1 = rng.integers(0, 2, size=g).astype(bool)
    m2 = rng.integers(0, 2, size=g).astype(bool)
    ct1 = lwe_ith_encrypt_bit(
        jax.random.key(1), jnp.array(m1), 0, lwe_keys[0], TINY.alpha, TINY.k, (g,)
    )
    ct2 = lwe_ith_encrypt_bit(
        jax.random.key(2), jnp.array(m2), 1, lwe_keys[1], TINY.alpha, TINY.k, (g,)
    )
    op_ids = jnp.array([GATE_IDS[o] for o in ops], dtype=jnp.int32)
    out = ccs.bootstrap(gate_affine(op_ids, ct1, ct2), scheme, TINY)
    got = np.asarray(lwe_decrypt_bit_mk(out, lwe_keys))
    want = np.array([CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)])
    np.testing.assert_array_equal(got, want)


def test_mk_gates_k4():
    """Four parties: the growing-mask party loop beyond k=2."""
    params = TINY4
    a = ccs.crs(jax.random.key(500), params)
    parties = [
        ccs.party_keygen(jax.random.key(600 + i), a, params) for i in range(params.k)
    ]
    lwe_keys = [p[0] for p in parties]
    scheme = ccs.setup(a, [p[2] for p in parties], params)
    rng = np.random.default_rng(11)
    g = 2
    ms = rng.integers(0, 2, size=(params.k, g)).astype(bool)
    cts = [
        lwe_ith_encrypt_bit(
            jax.random.key(700 + i), jnp.array(ms[i]), i, lwe_keys[i],
            params.alpha, params.k, (g,),
        )
        for i in range(params.k)
    ]
    res, mres = cts[0], ms[0]
    for i in range(1, params.k):
        res = ccs.bootstrap(gate_affine(GATE_IDS["NAND"], res, cts[i]), scheme, params)
        mres = np.array([not (x and y) for x, y in zip(mres, ms[i])])
    got = np.asarray(lwe_decrypt_bit_mk(res, lwe_keys))
    np.testing.assert_array_equal(got, mres)


def test_ccs_pallas_ntt_bit_identical(tiny_mk):
    lwe_keys, scheme = tiny_mk
    rng = np.random.default_rng(9)
    g = 4
    m1 = rng.integers(0, 2, size=g).astype(bool)
    m2 = rng.integers(0, 2, size=g).astype(bool)
    ct1 = lwe_ith_encrypt_bit(
        jax.random.key(1), jnp.array(m1), 0, lwe_keys[0], TINY.alpha, TINY.k, (g,)
    )
    ct2 = lwe_ith_encrypt_bit(
        jax.random.key(2), jnp.array(m2), 1, lwe_keys[1], TINY.alpha, TINY.k, (g,)
    )
    ct = gate_affine(0, ct1, ct2)
    ref = ccs.bootstrap(ct, scheme, TINY)
    got = ccs.bootstrap(ct, scheme, TINY, pallas_ntt=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(ref.a))
