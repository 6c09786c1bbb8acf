"""End-to-end KMS multi-key gate tests (reference test/KMS.jl, KMSblock.jl)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe.schemes import kms
from mktfhe.schemes.gates import (
    CLEAR_OPS,
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit_mk,
    lwe_ith_encrypt_bit,
)
from mktfhe.schemes.params import KmsBlockParams, KmsParams

TINY = KmsParams(
    n=8, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0,
    l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)

TINY_BLOCK = KmsBlockParams(
    d=4, ell=2, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0,
    l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)


def _run_gates(params):
    a = kms.crs(jax.random.key(300), params)
    parties = [
        kms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)
    ]
    lwe_keys = [p[0] for p in parties]
    scheme = kms.setup(a, [p[3] for p in parties], params)

    rng = np.random.default_rng(13)
    ops = ["NAND", "OR", "XNOR"]
    g = len(ops)
    m1 = rng.integers(0, 2, size=g).astype(bool)
    m2 = rng.integers(0, 2, size=g).astype(bool)
    ct1 = lwe_ith_encrypt_bit(
        jax.random.key(1), jnp.array(m1), 0, lwe_keys[0], params.alpha, params.k, (g,)
    )
    ct2 = lwe_ith_encrypt_bit(
        jax.random.key(2), jnp.array(m2), 1, lwe_keys[1], params.alpha, params.k, (g,)
    )
    op_ids = jnp.array([GATE_IDS[o] for o in ops], dtype=jnp.int32)
    out = kms.bootstrap(gate_affine(op_ids, ct1, ct2), scheme, params)
    got = np.asarray(lwe_decrypt_bit_mk(out, lwe_keys))
    want = np.array([CLEAR_OPS[o](bool(x), bool(y)) for o, x, y in zip(ops, m1, m2)])
    np.testing.assert_array_equal(got, want)


def test_kms_gates():
    _run_gates(TINY)


def test_kms_block_gates():
    _run_gates(TINY_BLOCK)


def test_kms_k4_phase2_depth():
    """k=4: exercises phase-2 merge depth beyond two parties."""
    params = KmsParams(
        n=4, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0,
        l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=4,
    )
    a = kms.crs(jax.random.key(800), params)
    parties = [
        kms.party_keygen(jax.random.key(900 + i), a, params) for i in range(params.k)
    ]
    lwe_keys = [p[0] for p in parties]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    rng = np.random.default_rng(23)
    g = 2
    ms = rng.integers(0, 2, size=(2, g)).astype(bool)
    ct1 = lwe_ith_encrypt_bit(
        jax.random.key(1), jnp.array(ms[0]), 0, lwe_keys[0], params.alpha, params.k, (g,)
    )
    ct2 = lwe_ith_encrypt_bit(
        jax.random.key(2), jnp.array(ms[1]), 3, lwe_keys[3], params.alpha, params.k, (g,)
    )
    out = kms.bootstrap(gate_affine(GATE_IDS["NOR"], ct1, ct2), scheme, params)
    got = np.asarray(lwe_decrypt_bit_mk(out, lwe_keys))
    want = np.array([not (x or y) for x, y in zip(ms[0], ms[1])])
    np.testing.assert_array_equal(got, want)


def test_kms_pallas_ntt_bit_identical():
    """bootstrap(pallas_ntt=True) routes every NTT through the natural-layout
    Pallas kernels; outputs must be bit-identical to the jnp path."""
    params = TINY
    a = kms.crs(jax.random.key(300), params)
    parties = [
        kms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)
    ]
    lwe_keys = [p[0] for p in parties]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    rng = np.random.default_rng(13)
    g = 4
    m1 = rng.integers(0, 2, size=g).astype(bool)
    m2 = rng.integers(0, 2, size=g).astype(bool)
    ct1 = lwe_ith_encrypt_bit(
        jax.random.key(1), jnp.array(m1), 0, lwe_keys[0], params.alpha, params.k, (g,)
    )
    ct2 = lwe_ith_encrypt_bit(
        jax.random.key(2), jnp.array(m2), 1, lwe_keys[1], params.alpha, params.k, (g,)
    )
    ct = gate_affine(0, ct1, ct2)
    ref = kms.bootstrap(ct, scheme, params)
    got = kms.bootstrap(ct, scheme, params, pallas_ntt=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(ref.a))
