"""Unit tests for the ring layer: modular scalar ops, NTT, CRT, torus ops.

The ground truth is host-side Python big-int arithmetic (exact), which is
what the reference only approximates with Float64/Float64x2 FFTs.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mktfhe.ring import (
    PRIMES,
    divbits,
    from_crt_u32,
    from_crt_u64,
    fwd_ntt,
    inv_ntt,
    lift_signed_small,
    lift_u32,
    lift_u64,
    make_crt_plan,
    make_plan,
    modsum,
    mulhi_u32,
    negacyclic_roll,
    shoup,
    shoup_mul,
)
from mktfhe.ring.modring import mulmod_runtime

rng = np.random.default_rng(0)


def test_mulhi_u32_exhaustive_random():
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint32)
    y = rng.integers(0, 1 << 32, size=4096, dtype=np.uint32)
    got = np.asarray(mulhi_u32(jnp.array(x), jnp.array(y)))
    want = ((x.astype(np.uint64) * y.astype(np.uint64)) >> 32).astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    # edge cases
    for a, b in [(0, 0), (2**32 - 1, 2**32 - 1), (1, 2**32 - 1), (2**16, 2**16)]:
        g = int(mulhi_u32(jnp.uint32(a), jnp.uint32(b)))
        assert g == (a * b) >> 32


@pytest.mark.parametrize("p", PRIMES)
def test_shoup_mul(p):
    w = rng.integers(0, p, size=1024, dtype=np.uint32)
    a = rng.integers(0, p, size=1024, dtype=np.uint32)
    w_sh = np.array([shoup(int(x), p) for x in w], dtype=np.uint32)
    got = np.asarray(shoup_mul(jnp.array(w), jnp.array(w_sh), jnp.array(a), p))
    want = (w.astype(np.uint64) * a.astype(np.uint64) % p).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", PRIMES)
def test_modsum(p):
    for n in [1, 2, 3, 4, 5, 17, 64, 100]:
        x = rng.integers(0, p, size=(n, 8), dtype=np.uint32)
        got = np.asarray(modsum(jnp.array(x), 0, p))
        want = (x.astype(np.object_).sum(axis=0) % p).astype(np.uint32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16, 256, 1024, 2048])
@pytest.mark.parametrize("npr", [2, 3])
def test_ntt_roundtrip(n, npr):
    plan = make_plan(n, npr)
    a = rng.integers(
        0, np.array(PRIMES[:npr], dtype=np.uint64)[:, None], size=(npr, n)
    ).astype(np.uint32)
    back = np.asarray(inv_ntt(fwd_ntt(jnp.array(a), plan), plan))
    np.testing.assert_array_equal(back, a)


def _schoolbook_negacyclic(a, b, q):
    """Exact negacyclic product with Python ints; a, b signed int lists."""
    n = len(a)
    c = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                c[k] += a[i] * b[j]
            else:
                c[k - n] -= a[i] * b[j]
    return [x % q for x in c]


@pytest.mark.parametrize("n", [16, 64])
def test_ntt_negacyclic_mul_vs_schoolbook_u32(n):
    plan = make_plan(n, 2)
    crt = make_crt_plan(2)
    key = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    digits = rng.integers(-256, 256, size=n, dtype=np.int32)

    khat = fwd_ntt(lift_u32(jnp.array(key), crt), plan)
    dhat = fwd_ntt(lift_signed_small(jnp.array(digits), crt), plan)
    p = plan.primes[:, None]
    prod = (
        khat.astype(jnp.uint64) * dhat.astype(jnp.uint64) % p.astype(jnp.uint64)
    ).astype(jnp.uint32)
    res = from_crt_u32(inv_ntt(prod, plan), crt)

    key_bal = [int(x) - (1 << 32) if x >= 1 << 31 else int(x) for x in key]
    want = _schoolbook_negacyclic([int(d) for d in digits], key_bal, 1 << 32)
    np.testing.assert_array_equal(np.asarray(res), np.array(want, dtype=np.uint32))


@pytest.mark.parametrize("n", [16, 64])
def test_ntt_negacyclic_mul_vs_schoolbook_u64(n):
    plan = make_plan(n, 3)
    crt = make_crt_plan(3)
    key = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * 2 + rng.integers(
        0, 2, size=n, dtype=np.uint64
    )
    digits = rng.integers(-2048, 2048, size=n, dtype=np.int32)

    khat = fwd_ntt(lift_u64(jnp.array(key), crt), plan)
    dhat = fwd_ntt(lift_signed_small(jnp.array(digits), crt), plan)
    p = plan.primes[:, None]
    prod = (
        khat.astype(jnp.uint64) * dhat.astype(jnp.uint64) % p.astype(jnp.uint64)
    ).astype(jnp.uint32)
    res = from_crt_u64(inv_ntt(prod, plan), crt)

    key_bal = [int(x) - (1 << 64) if x >= 1 << 63 else int(x) for x in key]
    want = _schoolbook_negacyclic([int(d) for d in digits], key_bal, 1 << 64)
    np.testing.assert_array_equal(np.asarray(res), np.array(want, dtype=np.uint64))


def test_crt_roundtrip_u32():
    crt = make_crt_plan(2)
    x = rng.integers(0, 1 << 32, size=1024, dtype=np.uint32)
    back = from_crt_u32(lift_u32(jnp.array(x), crt), crt)
    np.testing.assert_array_equal(np.asarray(back), x)


def test_crt_roundtrip_u64():
    crt = make_crt_plan(3)
    x = rng.integers(0, 1 << 63, size=1024, dtype=np.uint64) * 2 + rng.integers(
        0, 2, size=1024, dtype=np.uint64
    )
    back = from_crt_u64(lift_u64(jnp.array(x), crt), crt)
    np.testing.assert_array_equal(np.asarray(back), x)


def test_divbits_matches_reference_semantics():
    # divbits(a, bit) = round-to-nearest(a / 2^bit) with ties up, wrapping.
    for dtype, t in [(np.uint32, 32), (np.uint64, 64)]:
        a = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(dtype)
        for bit in [1, 5, t - 12, t - 1]:
            got = np.asarray(divbits(jnp.array(a), bit))
            ai = a.astype(np.object_)
            want = ((ai >> bit) + ((ai >> (bit - 1)) & 1)) % (1 << t)
            np.testing.assert_array_equal(got.astype(np.object_), want)


def test_negacyclic_roll():
    n = 16
    v = jnp.arange(1, n + 1, dtype=jnp.uint32)
    # X^1 * v: coefficients shift up one, top wraps negated
    r1 = np.asarray(negacyclic_roll(v, 1))
    want = np.concatenate([[np.uint32(0) - np.uint32(n)], np.arange(1, n, dtype=np.uint32)])
    np.testing.assert_array_equal(r1, want)
    # X^N == -1
    rn = np.asarray(negacyclic_roll(v, n))
    np.testing.assert_array_equal(rn, (0 - np.asarray(v)).astype(np.uint32))
    # X^2N == identity
    r2n = np.asarray(negacyclic_roll(v, 2 * n % (2 * n)))
    np.testing.assert_array_equal(r2n, np.asarray(v))


def _edge_values(p):
    """Residues and raw u32 words where the reductions change branch."""
    return sorted({0, 1, 2, p // 2, p - 2, p - 1})


def _check_mulhi(p):
    vals = _edge_values(p) + [p, 2 * p, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    for a in vals:
        for b in vals:
            assert int(mulhi_u32(jnp.uint32(a), jnp.uint32(b))) == (a * b) >> 32, (a, b)


def _check_shoup(p):
    # w < p; the multiplicand may be any u32 (Harvey's bound)
    for w in _edge_values(p):
        w_sh = shoup(w, p)
        for a in _edge_values(p) + [p, 4 * p - 1, (1 << 32) - 1]:
            got = int(shoup_mul(jnp.uint32(w), jnp.uint32(w_sh), jnp.uint32(a), p))
            assert got == w * a % p, (w, a)


def _check_mulmod_runtime(p):
    q = PRIMES.index(p)
    crt = make_crt_plan(4)
    for a in _edge_values(p):
        for b in _edge_values(p):
            got = int(
                mulmod_runtime(
                    jnp.uint32(a), jnp.uint32(b), p, crt.c32[q], crt.c32_shoup[q]
                )
            )
            assert got == a * b % p, (a, b)


@pytest.mark.parametrize("check", [_check_mulhi, _check_shoup, _check_mulmod_runtime],
                         ids=["mulhi_u32", "shoup_mul", "mulmod_runtime"])
@pytest.mark.parametrize("p", PRIMES)
def test_modmul_edges_vs_python_ints(p, check):
    """Every modular product the NTTs and phase 2 use, at the values where
    a conditional subtraction or a carry changes, against Python ints."""
    check(p)


@pytest.mark.parametrize("npr", [2, 3, 4])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_ntt_convolution_vs_schoolbook_per_prime(n, npr):
    """fwd -> pointwise product -> inv is the negacyclic product mod each
    prime, for full-range residues (not only small digits)."""
    plan = make_plan(n, npr)
    p = plan.primes.astype(np.uint64)[:, None]
    a = (rng.integers(0, 1 << 32, size=(npr, n), dtype=np.uint64) % p).astype(np.uint32)
    b = (rng.integers(0, 1 << 32, size=(npr, n), dtype=np.uint64) % p).astype(np.uint32)
    ah, bh = fwd_ntt(jnp.array(a), plan), fwd_ntt(jnp.array(b), plan)
    prod = (ah.astype(jnp.uint64) * bh.astype(jnp.uint64) % p).astype(jnp.uint32)
    got = np.asarray(inv_ntt(prod, plan))
    for q in range(npr):
        want = _schoolbook_negacyclic(
            [int(x) for x in a[q]], [int(x) for x in b[q]], int(plan.primes[q])
        )
        np.testing.assert_array_equal(got[q], np.array(want, dtype=np.uint32))
