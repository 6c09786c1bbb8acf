"""KMS two-phase multi-key bootstrapping (eprint 2022/1460), + block variant.

Counterpart of the KMS pieces of the reference: scheme + keygen
(/root/reference/src/tfhe/scheme.jl:254-350, keygen.jl:85-155), two-phase
blind rotation (bootstrapping.jl:369-558, :599-659) and key switch with
64->32-bit modulus switch (bootstrapping.jl:564-594, :664-695).

Dual torus widths: LWE ciphertexts live on the 2^32 torus; ring
accumulators on the 2^64 torus (exact via 3-4 CRT primes).

Phase 1 (party-parallel; `@spawn` in the reference, a vmap over the party
axis or a `shard_map` over a party mesh here): each party runs a
*single-key* CGGI-style blind rotation over an RLEV accumulator whose rows
carry the LEV gadget constants, producing a "lev key" = RLEV(X^rot_i) in
the NTT domain.  Party 1 needs only one row (its rotation is applied
directly to the test vector in phase 2).

Phase 2 (sequential merge): for each party, LEV-multiply the accumulator's
digits by that party's lev key (x from the b-parts, y from the a-parts),
relinearize y through the party's rlk (a uni-encryption of its GSW key
under its uni key) via the hybrid product, and fold back -- extending the
accumulator by one mask component per party.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ciphertext.decomp import balanced_decomp
from ..ciphertext.gsw import external_product_hat, rgsw_encrypt
from ..ciphertext.keys import (
    binary_lwe_key,
    binary_ring_key,
    block_binary_lwe_key,
    partial_ring_key,
)
from ..ciphertext.lwe import Lwe
from ..ciphertext.rlwe import gadget_gvec
from ..ciphertext.unienc import gen_b, sample_crs, unienc_encrypt
from ..ring.context import RingCtx, make_ring_ctx
from ..ring.sampler import rng_streams
from ..ring.modring import addmod, modsum, mulmod_runtime, negmod, shoup_mul
from ..ring.ntt import fwd_ntt, inv_ntt, shoup_pair
from ..ring.torus import from_crt, lift, lift_signed_small, negacyclic_roll
from .common import (
    build_ksk,
    initial_acc,
    keyswitch_per_party,
    mod_switch_2n,
    sample_extract_coeffs,
    signed_onehot,
)
from .params import KmsBlockParams, KmsParams

# top-level sampling streams consumed by keygen (ring/sampler.rng_streams)
KEYGEN_STREAMS = 7


class KmsPartyKey(NamedTuple):
    """One party's bootstrapping material, torus domain (BootKey_KMS,
    keygen.jl:85-118); serializable, what crosses the party boundary."""

    pub_b: jnp.ndarray  # [l_uni, N] uint64, public key vs the CRS (unikey)
    brk: jnp.ndarray  # [n, 2, l_gsw, 2, N] uint64, RGSW(s_i) under gswkey
    rlk_d: jnp.ndarray  # [l_uni, N] uint64, UniEnc(gswkey) d-vector
    rlk_f: jnp.ndarray  # [l_uni, 2, N] uint64, UniEnc(gswkey) RLEV part
    ksk_b: jnp.ndarray  # [NLIMB, rows] int8 (encrypts unikey coeffs, u32)
    ksk_a: jnp.ndarray  # [NLIMB, rows, n] int8


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class KmsScheme:
    """Aggregated runtime state (reference KMS struct, scheme.jl:256-265)."""

    crs_hat: jnp.ndarray  # [l_uni, npr, N]
    crs_shoup: jnp.ndarray
    pub_b_hat: jnp.ndarray  # [k, l_uni, npr, N]
    pub_b_shoup: jnp.ndarray
    brk_hat: jnp.ndarray  # [k, n, 2, l_gsw, 2, npr, N]
    brk_shoup: jnp.ndarray
    rlk_d_hat: jnp.ndarray  # [k, l_uni, npr, N]
    rlk_d_shoup: jnp.ndarray
    rlk_f_hat: jnp.ndarray  # [k, l_uni, 2, npr, N]
    rlk_f_shoup: jnp.ndarray
    ksk_b: jnp.ndarray  # [k, NLIMB, rows]
    ksk_a: jnp.ndarray  # [k, NLIMB, rows, n]
    mono_hat: jnp.ndarray  # [2N, npr, N] (block variant; zeros otherwise)
    mono_shoup: jnp.ndarray


AnyKmsParams = KmsParams | KmsBlockParams


def _ctx(params: AnyKmsParams) -> RingCtx:
    return make_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)


def crs(rng, params: AnyKmsParams):
    """Common reference string (scheme.jl:409-410)."""
    return sample_crs(rng, params.l_uni, _ctx(params))


@functools.partial(jax.jit, static_argnames=("params",))
def party_keygen(rng, crs_polys, params: AnyKmsParams):
    """Independent per-party keygen (scheme.jl:273-287, keygen.jl:85-118).

    Returns (lwe_key [u32], gsw_key, uni_key, KmsPartyKey).
    """
    ctx = _ctx(params)
    is_block = isinstance(params, KmsBlockParams)
    k_lwe, k_gsw, k_uni, k_b, k_rlk, k_brk, k_ksk = rng_streams(rng, KEYGEN_STREAMS)
    if is_block:
        lwe_key = block_binary_lwe_key(k_lwe, params.d, params.ell, jnp.uint32)
        uni_key = partial_ring_key(k_uni, 1, lwe_key, ctx)
    else:
        lwe_key = binary_lwe_key(k_lwe, params.n, jnp.uint32)
        uni_key = binary_ring_key(k_uni, 1, ctx)
    gsw_key = binary_ring_key(k_gsw, 1, ctx)

    pub_b = gen_b(k_b, crs_polys, uni_key, params.beta, ctx)
    rlk = unienc_encrypt(
        k_rlk, gsw_key.key[0], crs_polys, uni_key, params.beta,
        params.l_uni, params.log_b_uni, ctx,
    )
    rngs = jax.random.split(k_brk, params.n)
    brk = jax.vmap(
        lambda r, bit: rgsw_encrypt(
            r, bit.astype(ctx.dtype), gsw_key, params.beta,
            params.l_gsw, params.log_b_gsw, ctx,
        )
    )(rngs, lwe_key.key)

    # ksk encrypts the (binary) uni-key coefficients on the 2^32 torus under
    # the party's LWE key (keygen.jl:110-114); block variant covers only the
    # tail beyond n (keygen.jl:147-151).
    coeffs = uni_key.key[0].astype(jnp.uint32)
    if is_block:
        coeffs = coeffs[params.n :]
    ksk_b, ksk_a = build_ksk(
        k_ksk, coeffs, lwe_key, params.f, params.log_d, params.alpha
    )
    return lwe_key, gsw_key, uni_key, KmsPartyKey(
        pub_b=pub_b, brk=brk, rlk_d=rlk.d, rlk_f=rlk.f, ksk_b=ksk_b, ksk_a=ksk_a
    )


def _monomial_table(ctx: RingCtx):
    from .lmss import monomial_table

    return monomial_table(ctx)


@functools.partial(jax.jit, static_argnames=("params",))
def setup(crs_polys, party_keys: list[KmsPartyKey], params: AnyKmsParams) -> KmsScheme:
    """Aggregate party keys (scheme.jl:292-299, :343-350)."""
    ctx = _ctx(params)

    def hat(x):
        h = fwd_ntt(lift(x, ctx.crt), ctx.plan)
        return h, shoup_pair(h, ctx.plan)

    crs_hat, crs_shoup = hat(crs_polys)
    pub_hat, pub_shoup = hat(jnp.stack([pk.pub_b for pk in party_keys]))
    brk_hat, brk_shoup = hat(jnp.stack([pk.brk for pk in party_keys]))
    rd_hat, rd_shoup = hat(jnp.stack([pk.rlk_d for pk in party_keys]))
    rf_hat, rf_shoup = hat(jnp.stack([pk.rlk_f for pk in party_keys]))
    if isinstance(params, KmsBlockParams):
        mono_hat, mono_shoup = _monomial_table(ctx)
    else:
        mono_hat = mono_shoup = jnp.zeros((0,), dtype=jnp.uint32)
    return KmsScheme(
        crs_hat=crs_hat, crs_shoup=crs_shoup,
        pub_b_hat=pub_hat, pub_b_shoup=pub_shoup,
        brk_hat=brk_hat, brk_shoup=brk_shoup,
        rlk_d_hat=rd_hat, rlk_d_shoup=rd_shoup,
        rlk_f_hat=rf_hat, rlk_f_shoup=rf_shoup,
        ksk_b=jnp.stack([pk.ksk_b for pk in party_keys]),
        ksk_a=jnp.stack([pk.ksk_a for pk in party_keys]),
        mono_hat=mono_hat, mono_shoup=mono_shoup,
    )


def _ntt_fns(pallas_ntt: bool, interpret: bool = False):
    """Forward/inverse transform pair: jnp (one device-memory pass per
    stage) or the Pallas kernels (all stages on chip, bit-identical)."""
    if pallas_ntt:
        from ..kernels.ntt_pallas import fwd_ntt_pallas, inv_ntt_pallas

        return (
            functools.partial(fwd_ntt_pallas, interpret=interpret),
            functools.partial(inv_ntt_pallas, interpret=interpret),
        )
    return fwd_ntt, inv_ntt


def _decomp_hat(x, l, log_b, ctx, fwd=fwd_ntt):
    d = jnp.moveaxis(balanced_decomp(x, l, log_b), -1, -2)
    return fwd(lift_signed_small(d, ctx.crt), ctx.plan)


def _phase1_init(iter_rows: int, params: AnyKmsParams, ctx: RingCtx, g: int):
    """RLEV accumulator rows carrying the LEV gadget constants
    (bootstrapping.jl:400-407)."""
    gvec = gadget_gvec(params.l_lev, params.log_b_lev, ctx.dtype)[:iter_rows]
    acc = jnp.zeros((g, iter_rows, 2, ctx.n), dtype=ctx.dtype)
    return acc.at[:, :, 0, 0].set(gvec[None, :])


def phase1(tildea_p, brk_hat_p, brk_shoup_p, iter_rows: int, params, ctx: RingCtx, pallas_ntt: bool = False, interpret: bool = False):
    """Single-key blind rotation over an RLEV accumulator
    (bootstrapping.jl:389-443).  tildea_p: [G, n]; returns the party's "lev
    key" in the NTT domain: [G, iter_rows, 2, npr, N]."""
    fwd, inv = _ntt_fns(pallas_ntt, interpret)
    g = tildea_p.shape[0]
    acc = _phase1_init(iter_rows, params, ctx, g)

    def step(acc, xs):
        brk_h, brk_s, ta = xs
        dhat = _decomp_hat(acc, params.l_gsw, params.log_b_gsw, ctx, fwd)
        # [G, rows, 2, l, npr, N] x [2, l, 2, npr, N] -> [G, rows, 2, npr, N]
        ehat = external_product_hat(dhat, brk_h, brk_s, ctx)
        e = from_crt(inv(ehat, ctx.plan), ctx.crt, ctx.dtype)
        rolled = jax.vmap(negacyclic_roll)(e, ta.astype(jnp.int32))
        return acc + rolled - e, None

    acc, _ = jax.lax.scan(step, acc, (brk_hat_p, brk_shoup_p, tildea_p.T))
    return fwd(lift(acc, ctx.crt), ctx.plan)


def phase1_block(tildea_p, brk_hat_p, brk_shoup_p, iter_rows: int, scheme, params, ctx: RingCtx, pallas_ntt: bool = False, interpret: bool = False):
    """Block-binary phase 1 (bootstrapping.jl:599-659): one decomposition
    per block, ell monomial-weighted external products accumulated in the
    evaluation domain."""
    fwd, inv = _ntt_fns(pallas_ntt, interpret)
    g = tildea_p.shape[0]
    ell, d = params.ell, params.d
    acc = _phase1_init(iter_rows, params, ctx, g)
    brk_h = brk_hat_p.reshape(d, ell, *brk_hat_p.shape[1:])
    brk_s = brk_shoup_p.reshape(d, ell, *brk_shoup_p.shape[1:])
    ta_blocks = tildea_p.T.reshape(d, ell, -1)
    p = ctx.plan.primes[:, None]

    def step(acc, xs):
        bh, bs, ta = xs
        dhat = _decomp_hat(acc, params.l_gsw, params.log_b_gsw, ctx, fwd)

        def member(carry, mxs):
            b_h, b_s, t = mxs
            ehat = external_product_hat(dhat, b_h, b_s, ctx)
            mono = scheme.mono_hat[t][:, None, None]  # [G,1,1,npr,N]
            mono_s = scheme.mono_shoup[t][:, None, None]
            return addmod(carry, shoup_mul(mono, mono_s, ehat, p), p), None

        zero = jnp.zeros((g, acc.shape[1], 2, ctx.nprimes, ctx.n), dtype=jnp.uint32)
        tacc2, _ = jax.lax.scan(member, zero, (bh, bs, ta))
        e = from_crt(inv(tacc2, ctx.plan), ctx.crt, ctx.dtype)
        return acc + e, None

    acc, _ = jax.lax.scan(step, acc, (brk_h, brk_s, ta_blocks))
    return fwd(lift(acc, ctx.crt), ctx.plan)


def _phase2_party(acc, levkey, p1: int, scheme: KmsScheme, params, ctx: RingCtx, pallas_ntt: bool = False, interpret: bool = False):
    """One merge step of phase 2 (bootstrapping.jl:468-557).

    acc: [G, k+1, N] uint64 (components > p1 are zero); levkey:
    [G, iter, 2, npr, N].  Returns the new acc with component p1 filled.
    """
    return _phase2_party_mat(
        acc, levkey, p1,
        scheme.rlk_d_hat[p1 - 1], scheme.rlk_d_shoup[p1 - 1],
        scheme.rlk_f_hat[p1 - 1], scheme.rlk_f_shoup[p1 - 1],
        scheme.pub_b_hat[: p1 - 1], scheme.pub_b_shoup[: p1 - 1],
        scheme.crs_hat, scheme.crs_shoup,
        params, ctx, pallas_ntt=pallas_ntt, interpret=interpret,
    )


def _phase2_party_mat(acc, levkey, p1: int, rd, rd_s, rf, rf_s, pub_h, pub_s, crs_hat, crs_shoup, params, ctx: RingCtx, pallas_ntt: bool = False, interpret: bool = False):
    """_phase2_party with this step's key material passed explicitly:
    rd/rd_s [l_uni, npr, N] (party p1's rlk d-vector), rf/rf_s
    [l_uni, 2, npr, N] (its rlk RLEV part), pub_h/pub_s
    [p1-1, l_uni, npr, N] (the EARLIER parties' public keys).  The
    party-sharded phase-2 path (parallel/shardmap.py) broadcasts exactly
    these slices per step instead of replicating the full k-party tables.
    """
    fwd, inv = _ntt_fns(pallas_ntt, interpret)
    p = ctx.plan.primes[:, None]
    crt = ctx.crt
    iter_rows = levkey.shape[1]

    # LEV contraction of acc's components 0..p1-1 against the lev key
    # (bootstrapping.jl:470-499).  Only the first iter_rows digits engage.
    sl = acc[:, :p1]  # [G, p1, N]
    dhat = _decomp_hat(sl, params.l_lev, params.log_b_lev, ctx, fwd)[:, :, :iter_rows]

    def lev_contract(lk_part):  # lk_part: [G, iter, npr, N]
        prods = mulmod_runtime(
            dhat,
            lk_part[:, None],
            p,
            crt.c32[:, None],
            crt.c32_shoup[:, None],
        )
        return modsum(prods, -3, p)  # [G, p1, npr, N]

    x = lev_contract(levkey[:, :, 0])
    y = lev_contract(levkey[:, :, 1])
    y_t = from_crt(inv(y, ctx.plan), crt, ctx.dtype)  # [G, p1, N]

    # hybrid product of y with this party's rlk (bootstrapping.jl:506-553)
    yhat = _decomp_hat(y_t, params.l_uni, params.log_b_uni, ctx, fwd)  # [G,p1,l,npr,N]
    u = modsum(shoup_mul(rd[None, None], rd_s[None, None], yhat, p), -3, p)

    v0 = negmod(
        modsum(
            shoup_mul(crs_hat[None], crs_shoup[None], yhat[:, 0], p),
            -3,
            p,
        ),
        p,
    )
    if p1 > 1:
        vi = modsum(shoup_mul(pub_h[None], pub_s[None], yhat[:, 1:], p), -3, p)
        v = addmod(v0, modsum(vi, -3, p), p)
    else:
        v = v0
    v_t = from_crt(inv(v, ctx.plan), crt, ctx.dtype)  # [G, N]

    vhat = _decomp_hat(v_t, params.l_uni, params.log_b_uni, ctx, fwd)  # [G, l, npr, N]
    w_b = modsum(shoup_mul(rf[None, :, 0], rf_s[None, :, 0], vhat, p), -3, p)
    w_a = modsum(shoup_mul(rf[None, :, 1], rf_s[None, :, 1], vhat, p), -3, p)

    # assemble tx = x + u + w (bootstrapping.jl:548-556)
    tx = addmod(x, u, p)
    tx = tx.at[:, 0].set(addmod(tx[:, 0], w_b, p))
    tx = jnp.concatenate([tx, w_a[:, None]], axis=1)  # [G, p1+1, npr, N]
    new = from_crt(inv(tx, ctx.plan), crt, ctx.dtype)
    g = acc.shape[0]
    pad = jnp.zeros((g, acc.shape[1] - p1 - 1, ctx.n), dtype=ctx.dtype)
    return jnp.concatenate([new, pad], axis=1)


def blind_rotate(tildea, tildeb, scheme: KmsScheme, params: AnyKmsParams, ctx: RingCtx, pallas_ntt: bool = False, interpret: bool = False):
    """Two-phase multi-key blind rotation (bootstrapping.jl:369-384).

    tildea: [G, k*n]; tildeb: [G].  Returns acc [G, k+1, N] uint64.

    Phase 1 is vmapped over the party axis with a uniform l_lev rows per
    party (the reference spawns one task per party, :376-378; party 1's
    extra rows beyond its single needed row are redundant but make the
    party axis uniform, so one fused scan serves all parties -- and the
    same code shards over a `party` mesh axis, parallel/mesh.py).  Phase 2
    consumes row 0 only for party 1, matching the reference's iter=1
    special case at :400,:481.
    """
    k = params.k
    g = tildea.shape[0]
    tild = tildea.reshape(g, k, params.n)
    is_block = isinstance(params, KmsBlockParams)

    def p1_fn(ta_p, brk_h, brk_s):
        if is_block:
            return phase1_block(
                ta_p, brk_h, brk_s, params.l_lev, scheme, params, ctx, pallas_ntt, interpret
            )
        return phase1(ta_p, brk_h, brk_s, params.l_lev, params, ctx, pallas_ntt, interpret)

    tild_pm = jnp.moveaxis(tild, 1, 0)  # [k, G, n]
    levkeys = jax.vmap(p1_fn)(tild_pm, scheme.brk_hat, scheme.brk_shoup)

    acc = initial_acc(tildeb, params.big_n, k, ctx.dtype)
    for p1 in range(1, k + 1):
        iter_rows = 1 if p1 == 1 else params.l_lev
        acc = _phase2_party(
            acc, levkeys[p1 - 1][:, :iter_rows], p1, scheme, params, ctx, pallas_ntt, interpret
        )
    return acc


def _keyswitch(acc, scheme: KmsScheme, params: AnyKmsParams) -> Lwe:
    """Modulus switch 2^64 -> 2^32 then per-party key switch
    (bootstrapping.jl:564-594; block: :664-695 with free head segment)."""
    acc32 = (acc >> 32).astype(jnp.uint32)
    if not isinstance(params, KmsBlockParams):
        return keyswitch_per_party(
            acc32, scheme.ksk_b, scheme.ksk_a, params.f, params.log_d
        )
    # block: per party, the first n extracted coefficients pass for free;
    # the tail goes through a balanced-digit matmul against the party ksk.
    n = params.n
    b0 = acc32[..., 0, 0]
    arr = sample_extract_coeffs(acc32[..., 1:, :])  # [G, k, N]
    free = arr[..., :n]
    tail = arr[..., n:]
    digits = balanced_decomp(tail, params.f, params.log_d)  # [G,k,tail,f]
    oh = signed_onehot(digits, params.log_d)
    flat = oh.reshape(*oh.shape[:-2], -1)
    outb = None
    outa = None
    for limb in range(scheme.ksk_b.shape[1]):
        pb = jnp.einsum(
            "gkr,kr->gk", flat, scheme.ksk_b[:, limb], preferred_element_type=jnp.int32
        )
        pa = jnp.einsum(
            "gkr,krn->gkn", flat, scheme.ksk_a[:, limb], preferred_element_type=jnp.int32
        )
        outb = (pb << (8 * limb)) if outb is None else outb + (pb << (8 * limb))
        outa = (pa << (8 * limb)) if outa is None else outa + (pa << (8 * limb))
    u32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
    b = b0 + jnp.sum(u32(outb), axis=-1, dtype=jnp.uint32)
    a = (free + u32(outa)).reshape(arr.shape[0], -1)
    return Lwe(b=b, a=a)


@functools.partial(jax.jit, static_argnames=("params", "pallas_ntt", "interpret"))
def bootstrap(ct: Lwe, scheme: KmsScheme, params: AnyKmsParams, pallas_ntt: bool = False, interpret: bool = False) -> Lwe:
    """Multi-key gate bootstrap (bootstrapping.jl:4-27, KMS dispatch).

    ct: Lwe on the 2^32 torus with b [G], a [G, k*n].  pallas_ntt routes
    every NTT through the Pallas kernels (kernels/ntt_pallas.py,
    bit-identical; GPU only unless interpret=True).
    """
    ctx = _ctx(params)
    tildeb, tildea = mod_switch_2n(ct, params.big_n)
    acc = blind_rotate(tildea, tildeb, scheme, params, ctx, pallas_ntt, interpret)
    return _keyswitch(acc, scheme, params)
