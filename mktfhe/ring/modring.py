"""Exact modular arithmetic over NTT-friendly CRT primes, in uint32.

This replaces the reference's float FFT arithmetic
(/root/reference/src/ring/fft.jl, /root/reference/src/ring/arithmetic.jl).
The reference computes negacyclic polynomial products through a Float64
complex FFT (admitting precision loss; exactness is recovered only in keygen
via Float64x2).  We instead compute products *exactly* over a residue
number system: every torus polynomial is mapped to residues modulo a few
29.4-bit primes, multiplied with integer NTTs, and reconstructed mod
2^32 / 2^64 with Garner's algorithm.  All hot operations are uint32
adds/multiplies, with constants multiplied via Shoup's precomputed-quotient
trick (one mulhi + two wrapping multiplies per modular multiplication).

Primes: p ≡ 1 (mod 2^13) so a 2N-th root of unity exists for every ring
dimension N ≤ 4096 used by the parameter presets (N = 1024, 2048;
/root/reference/src/tfhe/params.jl:4,50).  p < 2^32/6 (≈ 2^29.42) leaves
headroom for lazy reductions: Shoup products land in [0, 2p), an
approximate-quotient Shoup product (error ≤ 1) lands in [0, 3p), and two
such products can be summed in a uint32 (6p < 2^32) before any
conditional subtraction.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# NTT-friendly primes, each ≡ 1 (mod 2^13), just below 2^32/6, with a
# known primitive root.  Two primes (2^58.8 of CRT range) cover every
# uint32-torus contraction in the framework; three (2^88.2) cover the
# uint64-torus KMS contractions except KMS2party's log_b=12 gadget (2^89.6
# bound -> 4 primes).  See mktfhe/schemes/params.py for the per-scheme
# bound verification.  6p < 2^32 leaves room for lazy reductions (an
# approximate Shoup quotient with error <= 1 gives products < 3p, and two
# such products sum without overflow) while 3 primes still exceed the
# 2^87 KMS8 contraction bound.
PRIMES: tuple[int, ...] = (715825153, 715726849, 715694081, 715358209)
_PRIMITIVE_ROOTS: dict[int, int] = {
    715825153: 5,
    715726849: 11,
    715694081: 3,
    715358209: 13,
}

U32 = jnp.uint32
MASK16 = np.uint32(0xFFFF)


def nprimes_for_bits(torus_bits: int) -> int:
    """Number of CRT primes needed for a given torus width (32 or 64)."""
    if torus_bits == 32:
        return 2
    if torus_bits == 64:
        return 3
    raise ValueError(f"unsupported torus width {torus_bits}")


def shoup(w: int, p: int) -> int:
    """Host-side Shoup precomputation: floor(w * 2^32 / p), for 0 <= w < p."""
    assert 0 <= w < p
    return (w << 32) // p


def mulhi_u32(x, y):
    """High 32 bits of the 64-bit product of two uint32 arrays.

    Built from four 16-bit partial products, so it stays exact in uint32
    on every backend without x64 (the same role the hand-unrolled SIMD
    butterflies play in the reference FFT,
    /root/reference/src/ring/fft.jl:105-210).
    """
    x0 = x & MASK16
    x1 = x >> 16
    y0 = y & MASK16
    y1 = y >> 16
    ll = x0 * y0
    hl = x1 * y0
    lh = x0 * y1
    hh = x1 * y1
    # cross <= (2^16-2) + (2^16-1) + (2^16-1)^2 < 2^32: no overflow.
    cross = (ll >> 16) + (hl & MASK16) + lh
    return hh + (hl >> 16) + (cross >> 16)


def shoup_mul(w, w_shoup, a, p):
    """(w * a) mod p with w a precomputed constant, exact for any a < 2^32.

    w < p, w_shoup = floor(w * 2^32 / p).  One mulhi + two wrapping
    multiplies + one conditional subtract (Harvey's bound: the pre-reduction
    value is in [0, 2p)).
    """
    p = U32(p)
    q = mulhi_u32(w_shoup, a)
    r = w * a - q * p  # wrapping uint32; r in [0, 2p)
    return jnp.where(r >= p, r - p, r)


def mulmod_runtime(a, b, p, c32, c32_shoup):
    """(a * b) mod p for two runtime values in [0, p) (no Shoup table).

    Full 64-bit product via mulhi, folded with the constant
    c32 = 2^32 mod p: a*b = hi*2^32 + lo => (hi*c32 + lo) mod p.
    Used where both operands are produced at runtime (e.g. KMS phase-2
    contractions against phase-1 outputs, bootstrapping.jl:484-505).
    """
    p = jnp.uint32(p)
    hi = mulhi_u32(a, b)
    lo = a * b  # wrapping
    lo_r = reduce_u32(lo, p)
    return addmod(shoup_mul(c32, c32_shoup, hi, p), lo_r, p)


def addmod(a, b, p):
    """(a + b) mod p for a, b in [0, p); p < 2^31 so the sum cannot wrap."""
    p = U32(p)
    s = a + b
    return jnp.where(s >= p, s - p, s)


def submod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    p = U32(p)
    d = a + (p - b)
    return jnp.where(d >= p, d - p, d)


def negmod(a, p):
    """(-a) mod p for a in [0, p)."""
    p = U32(p)
    return jnp.where(a == 0, a, p - a)


def reduce_u32(x, p):
    """x mod p for any uint32 x; p > 2^29 so floor(x/p) <= 7."""
    p = U32(p)
    two_p = p + p
    four_p = two_p + two_p
    x = jnp.where(x >= four_p, x - four_p, x)
    x = jnp.where(x >= two_p, x - two_p, x)
    return jnp.where(x >= p, x - p, x)


def modsum(x, axis, p):
    """Sum of values in [0, p) along `axis`, mod p.

    p < 2^30, so four reduced terms fit a uint32; we fold in rounds of four
    with a single reduction per round.  This is the accumulation pattern of
    the reference's `muladdto!` inner loop
    (/root/reference/src/ring/polynomial.jl:104-108) made exact.
    """
    p_u = U32(p)
    two_p = p_u + p_u
    x = jnp.moveaxis(x, axis, 0)
    while x.shape[0] > 1:
        n = x.shape[0]
        pad = (-n) % 4
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], dtype=x.dtype)], axis=0
            )
        x = x.reshape((x.shape[0] // 4, 4) + x.shape[1:])
        s = x[:, 0] + x[:, 1] + x[:, 2] + x[:, 3]  # < 4p < 2^32
        s = jnp.where(s >= two_p, s - two_p, s)
        x = jnp.where(s >= p_u, s - p_u, s)
    return x[0]


@functools.lru_cache(maxsize=None)
def _root_of_unity(p: int, order: int) -> int:
    """Primitive `order`-th root of unity mod p (host-side Python ints)."""
    assert (p - 1) % order == 0
    g = _PRIMITIVE_ROOTS[p]
    w = pow(g, (p - 1) // order, p)
    # primitivity check: w^(order/2) == -1
    assert pow(w, order // 2, p) == p - 1
    return w


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev
