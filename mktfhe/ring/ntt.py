"""Negacyclic number-theoretic transform over CRT primes.

Exact replacement for the reference's twisted complex FFT
(/root/reference/src/ring/fft.jl:48-210).  The reference folds
Z[X]/(X^N+1) into C[X]/(X^{N/2}+1) and runs Float64 Cooley-Tukey /
Gentleman-Sande butterflies (based on eprint 2016/504).  We use the same
eprint's *integer* formulation: a merged-twist negacyclic NTT over each CRT
prime, with the 2N-th root of unity psi folded into bit-reversed twiddle
tables, so no separate twist pass and no data bit-reversal are needed.
Forward output is in bit-reversed order; the inverse consumes it; pointwise
products in between are order-agnostic because keys are transformed with
the same forward transform.

Everything is computed batched as jnp arrays of shape [..., nprimes, N]
(uint32 residues in [0, p_i)), each stage a static reshape + elementwise
Shoup multiply.  XLA vectorizes the butterflies but materialises each stage
in device memory; kernels/ntt_pallas.py keeps all stages on chip.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .modring import (
    PRIMES,
    U32,
    _bitrev_perm,
    _root_of_unity,
    shoup,
    shoup_mul,
)


class NttPlan(NamedTuple):
    """Precomputed twiddle tables for a (N, nprimes) negacyclic NTT.

    psi_brv[q, t] = psi_q^{bitrev(t)} where psi_q is a primitive 2N-th root
    of unity mod PRIMES[q]; ipsi_brv likewise for psi^{-1}; n_inv folds the
    final 1/N scaling of the inverse transform (the reference folds it into
    rootsinv instead, /root/reference/src/ring/fft.jl:39-41).
    """

    n: int
    nprimes: int
    primes: jnp.ndarray  # [nprimes] uint32
    psi_brv: jnp.ndarray  # [nprimes, N] uint32
    psi_brv_shoup: jnp.ndarray  # [nprimes, N] uint32
    ipsi_brv: jnp.ndarray  # [nprimes, N] uint32
    ipsi_brv_shoup: jnp.ndarray  # [nprimes, N] uint32
    n_inv: jnp.ndarray  # [nprimes] uint32
    n_inv_shoup: jnp.ndarray  # [nprimes] uint32


@functools.lru_cache(maxsize=None)
def make_plan(n: int, nprimes: int) -> NttPlan:
    assert n & (n - 1) == 0, "ring dimension must be a power of two"
    primes = PRIMES[:nprimes]
    rev = _bitrev_perm(n)

    psi_tabs, psi_sh, ipsi_tabs, ipsi_sh, ninvs, ninv_sh = [], [], [], [], [], []
    for p in primes:
        psi = _root_of_unity(p, 2 * n)
        ipsi = pow(psi, -1, p)
        pw = np.array([pow(psi, int(t), p) for t in range(n)], dtype=np.uint64)
        ipw = np.array([pow(ipsi, int(t), p) for t in range(n)], dtype=np.uint64)
        pb = pw[rev]
        ipb = ipw[rev]
        psi_tabs.append(pb.astype(np.uint32))
        ipsi_tabs.append(ipb.astype(np.uint32))
        psi_sh.append(np.array([shoup(int(w), p) for w in pb], dtype=np.uint32))
        ipsi_sh.append(np.array([shoup(int(w), p) for w in ipb], dtype=np.uint32))
        ninv = pow(n, -1, p)
        ninvs.append(ninv)
        ninv_sh.append(shoup(ninv, p))

    # NOTE: tables are host numpy arrays, NOT jnp arrays: plans are built
    # lazily under lru_cache and may first be requested inside a jit trace,
    # where a jnp.array would be a tracer that must not be cached.  numpy
    # constants re-stage safely into any trace.
    return NttPlan(
        n=n,
        nprimes=nprimes,
        primes=np.array(primes, dtype=np.uint32),
        psi_brv=np.stack(psi_tabs),
        psi_brv_shoup=np.stack(psi_sh),
        ipsi_brv=np.stack(ipsi_tabs),
        ipsi_brv_shoup=np.stack(ipsi_sh),
        n_inv=np.array(ninvs, dtype=np.uint32),
        n_inv_shoup=np.array(ninv_sh, dtype=np.uint32),
    )


def _per_prime_p(plan: NttPlan):
    """Broadcastable prime vector for arrays shaped [..., nprimes, N]."""
    return plan.primes[:, None]


def fwd_ntt(a, plan: NttPlan):
    """Forward negacyclic NTT (Cooley-Tukey, natural -> bit-reversed order).

    a: uint32 residues [..., nprimes, N] with values < p_i.
    Counterpart of `fft!` at /root/reference/src/ring/fft.jl:105-155.
    """
    n = plan.n
    p = _per_prime_p(plan)
    lead = a.shape[:-2]
    npr = plan.nprimes
    m = 1
    t = n
    while m < n:
        t //= 2
        # view as [..., npr, m, 2, t]; block i pairs (a[j], a[j+t])
        x = a.reshape(lead + (npr, m, 2, t))
        s = plan.psi_brv[:, m : 2 * m, None]  # [npr, m, 1]
        s_sh = plan.psi_brv_shoup[:, m : 2 * m, None]
        u = x[..., 0, :]
        v = shoup_mul(s, s_sh, x[..., 1, :], p[..., None])
        hi = u + v
        hi = jnp.where(hi >= p[..., None], hi - p[..., None], hi)
        lo = u + (p[..., None] - v)
        lo = jnp.where(lo >= p[..., None], lo - p[..., None], lo)
        a = jnp.stack([hi, lo], axis=-2).reshape(lead + (npr, n))
        m *= 2
    return a


def inv_ntt(a, plan: NttPlan):
    """Inverse negacyclic NTT (Gentleman-Sande, bit-reversed -> natural).

    Counterpart of `ifft!` at /root/reference/src/ring/fft.jl:159-210.
    """
    n = plan.n
    p = _per_prime_p(plan)
    lead = a.shape[:-2]
    npr = plan.nprimes
    t = 1
    m = n
    while m > 1:
        h = m // 2
        x = a.reshape(lead + (npr, h, 2, t))
        s = plan.ipsi_brv[:, h : 2 * h, None]
        s_sh = plan.ipsi_brv_shoup[:, h : 2 * h, None]
        u = x[..., 0, :]
        v = x[..., 1, :]
        hi = u + v
        hi = jnp.where(hi >= p[..., None], hi - p[..., None], hi)
        d = u + (p[..., None] - v)
        d = jnp.where(d >= p[..., None], d - p[..., None], d)
        lo = shoup_mul(s, s_sh, d, p[..., None])
        a = jnp.stack([hi, lo], axis=-2).reshape(lead + (npr, n))
        t *= 2
        m = h
    return shoup_mul(plan.n_inv[:, None], plan.n_inv_shoup[:, None], a, p)


def pointwise_shoup(w, w_shoup, a, plan: NttPlan):
    """Pointwise product in the NTT domain; w is precomputed (keys/twiddles)."""
    return shoup_mul(w, w_shoup, a, _per_prime_p(plan))


def shoup_pair(w, plan: NttPlan):
    """Compute the Shoup companion table for precomputed NTT-domain values.

    w: uint32 [..., nprimes, N] values < p_i.  Done with uint64 host-style
    math in jnp (keygen-time only, not on the hot path).
    """
    p = _per_prime_p(plan).astype(jnp.uint64)
    return ((w.astype(jnp.uint64) << 32) // p).astype(U32)
