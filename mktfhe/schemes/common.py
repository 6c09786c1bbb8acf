"""Scheme-agnostic bootstrapping machinery.

Counterpart of the shared parts of /root/reference/src/tfhe/bootstrapping.jl:
the modulus switch + test-vector prologue (bootstrapping.jl:4-27) and the
key-switch epilogue -- redesigned for batched exact arithmetic:

  * The test vector is built branchlessly by a negacyclic roll (the
    reference branches on tildeb <= N, bootstrapping.jl:13-22).
  * Key switching becomes an int8 matmul: a *signed one-hot* encoding
    of the balanced gadget digits times a digit-value table of fresh LWE
    encryptions, split into four signed 8-bit limbs and recombined with
    wrapping shifts -- exact mod 2^32.  This replaces the reference's
    digit-value table lookup (bootstrapping.jl:81-109), which is
    gather-heavy and hostile to batched accelerators, while keeping its noise semantics
    exactly: each nonzero digit adds ONE fresh encryption noise unit
    (the reference's table has rows for every digit value,
    keygen.jl:17-23; its block variant halves the table with signed
    add/sub, keygen.jl:29-55 -- the signed value table here matches that).
    An earlier revision multiplied a single row coeff*g_j by the digit,
    scaling the fresh noise by E[d^2] = 3.5 (D=4); measured margins
    (MARGINS.md) showed that cost is NOT negligible, so it was replaced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ciphertext.decomp import balanced_decomp
from ..ciphertext.keys import LweKey
from ..ciphertext.lwe import Lwe, lwe_encrypt
from ..ciphertext.rlwe import gadget_gvec
from ..ring.torus import bits_of, divbits, negacyclic_roll

NLIMB = 4  # 8-bit limbs per uint32 key-switch coefficient


def mod_switch_2n(ct: Lwe, big_n: int):
    """Scale a T-bit LWE ciphertext to modulus 2N (bootstrapping.jl:8-9).

    Round-to-nearest can land exactly on 2N; reduce mod 2N so consumers
    indexing the 2N-entry monomial table stay in range (the roll-based
    engines are unaffected: X^2N = 1, and 2N is a power of two so the
    reduction is a mask).
    """
    t = bits_of(ct.b.dtype)
    log_n = big_n.bit_length() - 1
    shift = t - log_n - 1
    mask = ct.b.dtype.type(2 * big_n - 1)
    return divbits(ct.b, shift) & mask, divbits(ct.a, shift) & mask


def initial_acc(tildeb, big_n: int, k: int, ring_dtype):
    """RLWE accumulator with the +-1/8 test vector rotated by tildeb.

    tildeb: [...] values in [0, 2N).  Returns [..., k+1, N] (component 0=b).
    Matches the explicit construction at bootstrapping.jl:11-23: coefficient
    i (0-based) of b is +1/8 if i < tildeb <= N wrap-around etc.; here
    uniformly tv = X^tildeb * (-1/8 * sum_i X^i).
    """
    rt = bits_of(ring_dtype)
    eighth = jnp.array(1, dtype=ring_dtype) << (rt - 3)
    base = jnp.full((big_n,), -eighth, dtype=ring_dtype)
    roll = negacyclic_roll
    for _ in range(tildeb.ndim):
        roll = jax.vmap(roll, in_axes=(None, 0))
    tv = roll(base, tildeb.astype(jnp.int32))
    acc = jnp.zeros((*tildeb.shape, k + 1, big_n), dtype=ring_dtype)
    return acc.at[..., 0, :].set(tv)


def to_signed_limbs(v):
    """uint32 [...] -> int8 [..., NLIMB] balanced limbs: v = sum l_j 2^(8j)
    (mod 2^32) with l_j in [-128, 128); keeps int8 matmuls exact."""
    assert v.dtype == jnp.uint32
    limbs = []
    for i in range(NLIMB):
        d = v & jnp.uint32(0xFF)
        v = v >> 8
        carry = d >> 7
        v = v + carry
        limbs.append((d.astype(jnp.int32) - (carry.astype(jnp.int32) << 8)).astype(jnp.int8))
    return jnp.stack(limbs, axis=-1)


def sample_extract_coeffs(a):
    """Negacyclic sample extraction: [..., k, N] ring masks -> the LWE mask
    coefficients [a_0, -a_{N-1}, ..., -a_1] (bootstrapping.jl:90-99)."""
    return jnp.concatenate([a[..., :1], -jnp.flip(a[..., 1:], axis=-1)], axis=-1)


def build_ksk(rng, ring_coeffs, lwe_key: LweKey, f: int, log_d: int, sigma: float):
    """Key-switching key as int8 limb matrices for the matmul key switch.

    ring_coeffs: [rows] uint32 -- the target-key coefficients in extraction
    order.  One table row per (coeff, level j, digit value v) for
    v = 1..D/2, encrypting coeff * g_j * v -- the signed half of
    BootKey_bin's (D-1)-value table (keygen.jl:17-23; the signed-half
    layout matches the block variant, keygen.jl:29-55).  Consumed with the
    signed one-hot of *balanced* digits, so every nonzero digit adds
    exactly one fresh encryption noise unit.
    Returns (ksk_b [NLIMB, R] int8, ksk_a [NLIMB, R, n] int8) with
    R = rows * f * (D/2).
    """
    half = (1 << log_d) // 2
    gvec = gadget_gvec(f, log_d, jnp.uint32)  # [f]
    vals = jnp.arange(1, half + 1, dtype=jnp.uint32)  # [D/2]
    msgs = ring_coeffs[:, None, None] * gvec[None, :, None] * vals[None, None, :]
    ct = lwe_encrypt(rng, msgs, lwe_key, sigma, shape=msgs.shape)
    rows = msgs.size
    ksk_b = to_signed_limbs(ct.b.reshape(rows))  # [R, NLIMB]
    ksk_a = to_signed_limbs(ct.a.reshape(rows, -1))  # [R, n, NLIMB]
    return (
        jnp.moveaxis(ksk_b, -1, 0),
        jnp.moveaxis(ksk_a, -1, 0),
    )


def signed_onehot(digits, log_d: int):
    """Balanced digits int32 [..., f] in [-D/2, D/2) -> signed one-hot int8
    [..., f*(D/2)]: entry (j, v) is sign(d_j) iff |d_j| == v, matching the
    build_ksk table layout.  Contracting against the table reproduces
    sum_j d_j * coeff * g_j with one fresh noise unit per nonzero digit
    (the reference's table-lookup semantics, bootstrapping.jl:81-109)."""
    half = 1 << (log_d - 1)
    vs = jnp.arange(1, half + 1, dtype=digits.dtype)
    oh = (digits[..., None] == vs).astype(jnp.int8) - (
        digits[..., None] == -vs
    ).astype(jnp.int8)
    return oh.reshape(*digits.shape[:-1], digits.shape[-1] * half)


def _limb_matmul(digits_i8, ksk_b, ksk_a):
    """digits [..., rows] int8 x limb matrices -> (b [...], a [..., n]) uint32.

    The int8 x int8 -> int32 products accumulate exactly (|digit| < 256,
    |limb| <= 128, rows < 2^15 => |sum| < 2^30); the limb recombination
    shifts wrap mod 2^32, matching torus arithmetic.
    """
    outb = jnp.zeros(digits_i8.shape[:-1], dtype=jnp.int32)
    outa = None
    for limb in range(NLIMB):
        pb = jax.lax.dot_general(
            digits_i8,
            ksk_b[limb][:, None],
            (((digits_i8.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )[..., 0]
        pa = jax.lax.dot_general(
            digits_i8,
            ksk_a[limb],
            (((digits_i8.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        outb = outb + (pb << (8 * limb))
        outa = pa << (8 * limb) if outa is None else outa + (pa << (8 * limb))
    u32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
    return u32(outb), u32(outa)


def keyswitch_table(acc, ksk_b, ksk_a, f: int, log_d: int):
    """CGGI-style key switch (bootstrapping.jl:81-109).

    acc: [..., k+1, N] uint32 ring accumulator (component 0 = b).
    Returns Lwe with dim = ksk_a.shape[-1].
    """
    b = acc[..., 0, 0]
    arr = sample_extract_coeffs(acc[..., 1:, :])  # [..., k, N]
    digits = balanced_decomp(arr, f, log_d)  # [..., k, N, f]
    oh = signed_onehot(digits, log_d)  # [..., k, N, f*D/2]
    flat = oh.reshape(*oh.shape[:-3], -1)
    db, da = _limb_matmul(flat, ksk_b, ksk_a)
    return Lwe(b=b + db, a=da)


def keyswitch_per_party(acc, ksk_b, ksk_a, f: int, log_d: int):
    """Multi-key key switch (CCS/KMS, bootstrapping.jl:333-364, :564-594).

    acc: [..., k+1, N] uint32 (component i>=1 = party i's ring mask).
    ksk_b: [k, NLIMB, R] int8; ksk_a: [k, NLIMB, R, n] int8 (party-wise
    signed value tables, R = N*f*D/2).  Each party's extracted coefficients
    key-switch against its own ksk; partial b's sum (the reference's racy
    `res.b += partctxt[i].b` at :361 becomes a reduction) and the a
    segments concatenate into the k*n mask.  Returns Lwe of dimension k*n.
    """
    b0 = acc[..., 0, 0]
    arr = sample_extract_coeffs(acc[..., 1:, :])  # [..., k, N]
    digits = balanced_decomp(arr, f, log_d)  # [..., k, N, f]
    oh = signed_onehot(digits, log_d)  # [..., k, N, f*D/2]
    flat = oh.reshape(*oh.shape[:-2], -1)  # [..., k, R]
    k = flat.shape[-2]
    lead = flat.shape[:-2]
    outb = jnp.zeros(lead + (k,), dtype=jnp.int32)
    outa = None
    for limb in range(NLIMB):
        # batch over the party axis: [..., k, R] x [k, R, n] -> [..., k, n]
        pb = jnp.einsum(
            "...kr,kr->...k", flat, ksk_b[:, limb], preferred_element_type=jnp.int32
        )
        pa = jnp.einsum(
            "...kr,krn->...kn", flat, ksk_a[:, limb], preferred_element_type=jnp.int32
        )
        outb = outb + (pb << (8 * limb))
        outa = pa << (8 * limb) if outa is None else outa + (pa << (8 * limb))
    u32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
    b = b0 + jnp.sum(u32(outb), axis=-1, dtype=jnp.uint32)
    a = u32(outa).reshape(*lead, -1)
    return Lwe(b=b, a=a)


def keyswitch_partial(acc, n_free: int, ksk_b, ksk_a, f: int, log_d: int):
    """LMSS-style partial key switch (bootstrapping.jl:170-229).

    The ring key's first n_free coefficients ARE the LWE key, so those
    extracted coefficients pass through for free; the tail goes through a
    balanced decomposition whose signed one-hot contracts against the
    value table (the reference's add/sub branching at :196-201 vanishes
    into the +-1 one-hot entries).  ksk rows cover only the tail
    coefficients (R = (k*N - n_free) * f * D/2).
    acc: [..., k+1, N]; returns Lwe of dimension n_free.
    """
    b = acc[..., 0, 0]
    arr = sample_extract_coeffs(acc[..., 1:, :])  # [..., k, N]
    flat = arr.reshape(*arr.shape[:-2], -1)  # [..., k*N]
    free = flat[..., :n_free]
    tail = flat[..., n_free:]
    digits = balanced_decomp(tail, f, log_d)  # [..., tail, f] signed
    oh = signed_onehot(digits, log_d)
    dflat = oh.reshape(*oh.shape[:-2], -1)
    db, da = _limb_matmul(dflat, ksk_b, ksk_a)
    return Lwe(b=b + db, a=free + da)
