"""End-to-end CGGI gate bootstrapping tests (reference test/CGGI.jl semantics).

Uses reduced-size parameters for CPU speed; the preset-parameter smoke test
is marked slow (run on real hardware / in bench).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe.schemes import cggi
from mktfhe.schemes.gates import (
    CLEAR_OPS,
    GATE_IDS,
    gate_affine,
    lwe_decrypt_bit,
    lwe_encrypt_bit,
    not_gate,
)
from mktfhe.schemes.params import CggiParams

TINY = CggiParams(
    n=16, alpha=16.0, f=8, log_d=2, big_n=64, k=1, beta=16.0, l_gsw=3, log_b_gsw=8
)


@pytest.fixture(scope="module")
def tiny_scheme():
    return cggi.setup(jax.random.key(7), TINY)


def test_all_gates_batched(tiny_scheme):
    lwe_key, _ring_key, scheme = tiny_scheme
    ops = list(GATE_IDS)
    g = len(ops)
    rng = np.random.default_rng(3)
    m1 = rng.integers(0, 2, size=g).astype(bool)
    m2 = rng.integers(0, 2, size=g).astype(bool)
    ct1 = lwe_encrypt_bit(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = lwe_encrypt_bit(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    op_ids = jnp.array([GATE_IDS[o] for o in ops], dtype=jnp.int32)

    out = cggi.bootstrap(gate_affine(op_ids, ct1, ct2), scheme, TINY)
    got = np.asarray(lwe_decrypt_bit(out, lwe_key))
    want = np.array([CLEAR_OPS[o](bool(a), bool(b)) for o, a, b in zip(ops, m1, m2)])
    np.testing.assert_array_equal(got, want)


def test_gate_chain(tiny_scheme):
    """Chain bootstrapped outputs through further gates (noise refresh)."""
    lwe_key, _rk, scheme = tiny_scheme
    rng = np.random.default_rng(5)
    g = 4
    m = rng.integers(0, 2, size=(4, g)).astype(bool)
    cts = [
        lwe_encrypt_bit(jax.random.key(10 + i), jnp.array(m[i]), lwe_key, TINY.alpha, (g,))
        for i in range(4)
    ]
    res, mres = cts[0], m[0]
    chain = ["NAND", "XOR", "OR"]
    for i, op in enumerate(chain, start=1):
        res = cggi.bootstrap(gate_affine(GATE_IDS[op], res, cts[i]), scheme, TINY)
        mres = np.array([CLEAR_OPS[op](bool(x), bool(y)) for x, y in zip(mres, m[i])])
    got = np.asarray(lwe_decrypt_bit(res, lwe_key))
    np.testing.assert_array_equal(got, mres)


def test_not_gate(tiny_scheme):
    lwe_key, _rk, _s = tiny_scheme
    m = jnp.array([True, False])
    ct = lwe_encrypt_bit(jax.random.key(3), m, lwe_key, TINY.alpha, (2,))
    got = np.asarray(lwe_decrypt_bit(not_gate(ct), lwe_key))
    np.testing.assert_array_equal(got, ~np.asarray(m))
