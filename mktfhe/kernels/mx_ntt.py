"""Matmul-factored negacyclic NTT: 128-point stage as limb matmuls.

The reference's hot transform is a hand-SIMD float FFT
(/root/reference/src/ring/fft.jl:105-210).  ring/ntt.py replaces it with
an exact CRT-NTT whose butterflies are integer vector work (a Shoup modmul
is ~11 u32 ops).  This module moves the dominant 128-point half of the
transform onto a matrix unit as exact bf16 limb matmuls, leaving only a
cheap N/128-point transform plus twiddles as vector work.  It is the
reference for measuring that idea on tensor cores.

Factorization (derivation; N = 128*nb, psi = primitive 2N-th root mod p,
omega = psi^(2*nb) of order 256, Omega = psi^256 of order nb):

    n = nb*a' + b'          a' in [0,128), b' in [0,nb)
    k = k1 + 128*k2         k1 in [0,128), k2 in [0,nb)

    X[k] = sum_n x[n] psi^(n(2k+1))
         = sum_b' psi^(b'(2k1+1)) Omega^(b'k2)
             * [ sum_a' omega^(a'(2k1+1)) x[nb*a'+b'] ]

  - inner sum over a': a *k2-independent* 128x128 negacyclic-NTT matrix
    M[k1,a'] = omega^(a'(2k1+1)) -> one matmul per b' column;
  - twiddle T[k1,b'] = psi^(b'(2k1+1-128));
  - outer sum over b': a standard merged-twist negacyclic NTT of size nb
    with root psi^128 (4 butterfly stages for nb=16) applied along the
    *leading* array axis.

The mx domain is the ordinary NTT evaluation domain up to a fixed
permutation of evaluation points, so pointwise products, monomial tables
and key material work unchanged as long as every operand is transformed
with the same map (tests/test_mx_ntt.py checks it against ring/ntt.py).

Exactness of the bf16 matmuls: operands are integers with |v| <= 256
(gadget digits for log_b <= 9, signed base-256 limbs otherwise), bf16
represents all such integers exactly, and every f32 accumulation is
bounded by 128*256*128 = 2^22 < 2^24.

Coefficient-order convention: phase-1 accumulators live in the *permuted*
coefficient order coeff_mx[b'*128 + a'] = coeff[nb*a' + b'] so that both
transform stages are layout-aligned; all coefficient-domain ops in the
blind-rotation scan (gadget decomposition, Garner, accumulate) are
elementwise and order-agnostic.  `to_mx_order` / `from_mx_order` convert
at the scan boundaries.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ring.modring import shoup
from ..ring.ntt import make_plan
from ..ring.modring import _root_of_unity, PRIMES

NK = 128  # the matmul-contracted factor


class MxPlan:
    """Precomputed tables for the (128 x nb) split of an N-point NTT.

    All arrays are host numpy (safe to close over inside jit traces).

    fwd_mat      [npr, NK, NK] u32      M[k1,a'] = omega^(a'(2k1+1))
    fwd_mat_bf   [npr, LM, NK, NK] bf16 balanced base-256 limbs of M
    inv_mat      [npr, NK, NK] u32      C[a',k1] = omega^(-a'(2k1+1))/128
    inv_mat_bf   [npr, LD, LM, NK, NK]  limbs of (2^(8j) * C mod p)
    tw / tw_sh   [npr, nb, NK] u32      T[b',k1] = psi^(b'(2k1+1-128))
    itw / itw_sh [npr, nb, NK] u32      T^{-1}
    bt / bt_sh   [npr, S, nb]  u32      merged-twist CT twiddles (size-nb)
    ibt / ibt_sh [npr, S, nb]  u32      GS inverse (1/nb folded in)
    bmask        [S, nb] int            butterfly partner masks per stage
    """

    def __init__(self, n: int, nprimes: int):
        assert n % NK == 0 and n >= NK
        self.n = n
        self.nprimes = nprimes
        self.nb = nb = n // NK
        self.primes = PRIMES[:nprimes]
        s_count = nb.bit_length() - 1
        self.s_count = s_count

        def limbs_balanced(mat, count):
            """Balanced base-256 limb split of a nonnegative int matrix."""
            out = []
            rem = mat.astype(object).copy()
            for _ in range(count):
                d = ((rem + 128) % 256) - 128
                out.append(d.astype(np.float32))
                rem = (rem - d) // 256
            assert np.all(rem == 0), "limb count too small"
            return np.stack(out)

        fwd_mats, inv_mats, fwd_bfs, inv_bfs = [], [], [], []
        tws, tw_shs, itws, itw_shs = [], [], [], []
        bts, bt_shs, ibts, ibt_shs = [], [], [], []
        for p in self.primes:
            psi = _root_of_unity(p, 2 * n)
            omega = pow(psi, nb, p)  # order 2*N/nb = 256
            k1 = np.arange(NK, dtype=object)
            ap = np.arange(NK, dtype=object)
            expo = np.outer(ap, (2 * k1 + 1)) % 256
            pw = np.array([pow(omega, int(e), p) for e in range(256)], dtype=object)
            m = pw[expo.astype(int).T % 256]  # [k1, a']
            fwd_mats.append(m.astype(np.uint32))
            fwd_bfs.append(limbs_balanced(m, 4))

            inv128 = pow(NK, -1, p)
            iomega = pow(omega, -1, p)
            ipw = np.array([pow(iomega, int(e), p) for e in range(256)], dtype=object)
            c = (ipw[expo.astype(int) % 256] * inv128) % p  # [a', k1]
            inv_mats.append(c.astype(np.uint32))
            # data limbs j: matrices limbs of (2^(8j) * C mod p)
            ib = [limbs_balanced((c * pow(2, 8 * j, p)) % p, 4) for j in range(4)]
            inv_bfs.append(np.stack(ib))

            # twiddle: psi^(b'(2k1+1-128)) -- exponent may be negative
            bp = np.arange(nb, dtype=object)
            te = np.outer(bp, (2 * k1 + 1 - NK)) % (2 * n)
            ppw = np.array([pow(psi, int(e), p) for e in range(2 * n)], dtype=object)
            t = ppw[te.astype(int) % (2 * n)]  # [b', k1]
            tws.append(t.astype(np.uint32))
            tw_shs.append(
                np.vectorize(lambda w: shoup(int(w), p))(t).astype(np.uint32)
            )
            it = ppw[(-te.astype(int)) % (2 * n)]
            itws.append(it.astype(np.uint32))
            itw_shs.append(
                np.vectorize(lambda w: shoup(int(w), p))(it).astype(np.uint32)
            )

            # size-nb merged-twist stage twiddles: compact psi_brv-style
            # tables exactly as in ring/ntt.py's full-size plan, at ring
            # dimension nb with psi_nb = psi^(N/nb) (a primitive 2nb-th
            # root); fwd stage m uses pb[m:2m], inv stage h uses ipb[h:2h].
            psi_nb = pow(psi, n // nb, p)
            ipsi_nb = pow(psi_nb, -1, p)
            rev = _bitrev(nb)
            pw_nb = np.array([pow(psi_nb, int(tt), p) for tt in range(nb)], dtype=object)
            ipw_nb = np.array([pow(ipsi_nb, int(tt), p) for tt in range(nb)], dtype=object)
            bt = pw_nb[rev].astype(np.uint64).astype(np.uint32)
            ibt = ipw_nb[rev].astype(np.uint64).astype(np.uint32)
            bts.append(bt)
            bt_shs.append(np.vectorize(lambda w: shoup(int(w), p))(bt).astype(np.uint32))
            ibts.append(ibt)
            ibt_shs.append(np.vectorize(lambda w: shoup(int(w), p))(ibt).astype(np.uint32))

        self.fwd_mat = np.stack(fwd_mats)
        self.fwd_mat_bf = np.stack(fwd_bfs)  # [npr, 4, NK, NK] f32 (cast to bf16 at use)
        self.inv_mat = np.stack(inv_mats)
        self.inv_mat_bf = np.stack(inv_bfs)  # [npr, 4, 4, NK, NK]
        self.tw = np.stack(tws)
        self.tw_sh = np.stack(tw_shs)
        self.itw = np.stack(itws)
        self.itw_sh = np.stack(itw_shs)
        self.bt = np.stack(bts)  # [npr, nb] compact (bit-reversed psi_nb powers)
        self.bt_sh = np.stack(bt_shs)
        self.ibt = np.stack(ibts)
        self.ibt_sh = np.stack(ibt_shs)
        self.ninv_nb = np.array(
            [pow(nb, -1, p) for p in self.primes], dtype=np.uint32
        )
        self.ninv_nb_sh = np.array(
            [shoup(pow(nb, -1, p), p) for p in self.primes], dtype=np.uint32
        )


def _bitrev(n):
    bits = n.bit_length() - 1
    r = np.zeros(n, dtype=np.int64)
    for i in range(n):
        v, x = 0, i
        for _ in range(bits):
            v = (v << 1) | (x & 1)
            x >>= 1
        r[i] = v
    return r


@functools.lru_cache(maxsize=None)
def mx_plan(n: int, nprimes: int) -> MxPlan:
    return MxPlan(n, nprimes)


def to_mx_order(x, nb: int):
    """[..., N] coefficient order -> permuted mx coefficient order.

    coeff_mx[b'*128 + a'] = coeff[nb*a' + b'].
    """
    lead = x.shape[:-1]
    return (
        x.reshape(*lead, NK, nb).swapaxes(-1, -2).reshape(*lead, nb * NK)
    )


def from_mx_order(x, nb: int):
    """Inverse of to_mx_order."""
    lead = x.shape[:-1]
    return (
        x.reshape(*lead, nb, NK).swapaxes(-1, -2).reshape(*lead, nb * NK)
    )


# ─── exact jnp reference (keygen-time key transforms + test oracle) ──────


def _matmul_mod(m, x, p, contract_in: bool):
    """Exact modular matmul in u64 with chunked reduction.

    contract_in=True:  m [npr, K_out, A], x [..., npr, A, B] -> sum over A.
    contract_in=False: m [npr, A, K],  x [..., npr, B, K] -> sum over K
                       (output [..., npr, A, B]).
    Products of < 2^30 residues are < 2^60; 8-term partial sums stay below
    2^63, reduced mod p each chunk.
    """
    k = m.shape[-1]
    acc = None
    # broadcast multiply + sum over small chunks: exact u64 without a
    # u64 dot_general (keygen-time only).
    for c0 in range(0, k, 8):
        if contract_in:
            # m [npr, K, A] x [..., npr, A, B]: out[..., q, k, b]
            part = jnp.sum(
                m[:, :, c0 : c0 + 8, None] * x[..., None, c0 : c0 + 8, :],
                axis=-2,
            )
        else:
            # m [npr, A, K] x [..., npr, B, K]: out[..., q, a, b]
            part = jnp.sum(
                m[:, :, None, c0 : c0 + 8] * x[..., None, :, c0 : c0 + 8],
                axis=-1,
            )
        part = part % p[:, None, None]
        acc = part if acc is None else (acc + part) % p[:, None, None]
    return acc


def mx_fwd_ref(a, plan: MxPlan):
    """Exact forward mx-NTT in jnp (u32 math, no floats).

    a: [..., npr, N] residues in standard coefficient order.
    Returns [..., npr, N] in the mx evaluation domain (layout (k2, k1)
    flattened, k2 in the bit-reversed order of the size-nb CT stages).
    """
    from ..ring.modring import shoup_mul

    nb, n, npr = plan.nb, plan.n, plan.nprimes
    lead = a.shape[:-2]
    p = jnp.asarray(np.asarray(plan.primes, np.uint64))  # exact path: u64 ok
    x = a.reshape(*lead, npr, NK, nb).astype(jnp.uint64)  # [.., a', b']
    # stage A: W[k1, b'] = sum_a' M[k1,a'] x[a',b'].  Products are < 2^60,
    # so reduce mod p after every 8-term partial sum to stay exact in u64.
    m = jnp.asarray(plan.fwd_mat.astype(np.uint64))  # [npr, k1, a']
    w = _matmul_mod(m, x, p, contract_in=True)  # [..., npr, k1, b']
    # twiddle T[b',k1]
    tw = jnp.asarray(plan.tw.astype(np.uint64))  # [npr, b', k1]
    v = (w * jnp.moveaxis(tw, -1, -2)) % p[:, None, None]  # [..,q,k1,b']
    # stage B: merged-twist CT of size nb along the b' axis
    v = jnp.swapaxes(v, -1, -2)  # [..., npr, b', k1]
    bt = jnp.asarray(plan.bt.astype(np.uint64))  # [npr, nb] compact
    cur = v
    mlen = 1
    t = nb
    for s in range(plan.s_count):
        t //= 2
        shp = cur.shape[:-2]
        blkd = cur.reshape(*shp[:-1], npr, mlen, 2, t, NK)
        u = blkd[..., 0, :, :]
        vv = blkd[..., 1, :, :]
        tws = bt[:, mlen : 2 * mlen][:, :, None, None]
        vw = (vv * tws) % p[:, None, None, None]
        hi = (u + vw) % p[:, None, None, None]
        lo = (u + (p[:, None, None, None] - vw)) % p[:, None, None, None]
        cur = jnp.stack([hi, lo], axis=-3).reshape(*shp, nb, NK)
        mlen *= 2
    return cur.reshape(*lead, npr, n).astype(jnp.uint32)


def mx_inv_ref(a, plan: MxPlan):
    """Exact inverse of mx_fwd_ref (output in standard coefficient order)."""
    nb, n, npr = plan.nb, plan.n, plan.nprimes
    lead = a.shape[:-2]
    p = jnp.asarray(np.asarray(plan.primes, np.uint64))
    cur = a.reshape(*lead, npr, nb, NK).astype(jnp.uint64)
    ibt = jnp.asarray(plan.ibt.astype(np.uint64))  # [npr, nb] compact
    t = 1
    mlen = nb
    for s in range(plan.s_count):
        h = mlen // 2
        shp = cur.shape[:-2]
        blkd = cur.reshape(*shp[:-1], npr, h, 2, t, NK)
        u = blkd[..., 0, :, :]
        vv = blkd[..., 1, :, :]
        tws = ibt[:, h : 2 * h][:, :, None, None]
        hi = (u + vv) % p[:, None, None, None]
        lo = ((u + (p[:, None, None, None] - vv)) * tws) % p[:, None, None, None]
        cur = jnp.stack([hi, lo], axis=-3).reshape(*shp, nb, NK)
        t *= 2
        mlen = h
    ninv = jnp.asarray(plan.ninv_nb.astype(np.uint64))[:, None, None]
    cur = (cur * ninv) % p[:, None, None]
    # untwiddle + stage-A inverse matmul
    itw = jnp.asarray(plan.itw.astype(np.uint64))  # [npr, b', k1]
    v = (cur * itw) % p[:, None, None]  # [..., npr, b', k1]
    c = jnp.asarray(plan.inv_mat.astype(np.uint64))  # [npr, a', k1]
    x = _matmul_mod(c, v, p, contract_in=False)  # [..., npr, a', b']
    return x.reshape(*lead, npr, n).astype(jnp.uint32)
