"""Profiling and operation counts.

The reference's only performance machinery is `@time` prints
(/root/reference/test/KMS.jl:36).  Here: a jax.profiler trace context for
device traces, plus a static count of the integer operations, int8 MACs
and key bytes of each scheme's bootstrap.  These are counts, not times:
no device peak is kept here yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Device trace around a region (jax.profiler; read with xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class BootstrapCost:
    """Static per-gate cost model of a blind rotation + key switch."""

    ntt_elems: int  # element-passes through NTT butterflies
    int_ops: int  # estimated 32-bit integer ops outside the key switch
    int8_macs: int  # int8 MACs in the key switch
    key_bytes: int  # bootstrapping-key bytes streamed per batch


def kms_cost(params, nprimes: int = 3) -> BootstrapCost:
    """Per-gate cost of a KMS two-phase bootstrap (SURVEY.md section 3.3,
    bootstrapping.jl:369-558).  A Shoup modmul counts ~11 u32 ops, a
    butterfly ~14.
    """
    n, big_n, k = params.n, params.big_n, params.k
    l, l_lev, l_uni = params.l_gsw, params.l_lev, params.l_uni
    logn = int(math.log2(big_n))
    cpl = 2 * l  # decomposed digit polys per step (2 components x l)
    rows = l_lev  # uniform RLEV rows in phase 1

    # phase 1, per party per step: cpl fwd + 2 inv transforms, 2*cpl*2
    # pointwise muls, mono weight, decomp+Garner overhead
    fwd_elems = cpl * nprimes * big_n * logn // 2  # butterflies
    inv_elems = 2 * nprimes * big_n * logn // 2
    pointwise = nprimes * big_n * (cpl * 2 + 2)
    glue = big_n * (10 * cpl + 30)  # decomp digits + Garner + u64 adds
    step_ops = (fwd_elems + inv_elems) * 14 + pointwise * 11 + glue
    p1_ops = k * rows * n * step_ops

    # phase 2, party p1: LEV contract (p1*l_lev fwd + 2 inv round trips),
    # hybrid product (~(p1*l_uni + l_uni) fwd + 2 inv + p1+2 out inv)
    p2_ntt_polys = sum(
        p1 * l_lev + 2 + p1 * l_uni + l_uni + (p1 + 2) for p1 in range(1, k + 1)
    )
    p2_ops = p2_ntt_polys * nprimes * big_n * logn // 2 * 14

    ks_macs = 4 * k * params.f * big_n * (n + 1)
    brk_bytes = k * n * nprimes * cpl * 2 * big_n * 4 * 2
    return BootstrapCost(
        ntt_elems=(fwd_elems + inv_elems) * 2 * k * rows * n,
        int_ops=p1_ops + p2_ops,
        int8_macs=ks_macs,
        key_bytes=brk_bytes,
    )


def lmss_cost(params, nprimes: int = 2) -> BootstrapCost:
    """Per-gate cost of an LMSS block-binary bootstrap
    (bootstrapping.jl:114-165): one decomposition + (k+1)*l forward
    transforms per BLOCK (d blocks), ell monomial-weighted external
    products accumulated in the evaluation domain, then k+1 inverses."""
    big_n, k, l, d, ell = params.big_n, params.k, params.l_gsw, params.d, params.ell
    logn = int(math.log2(big_n))
    fwd = (k + 1) * l * nprimes * big_n * logn // 2
    inv = (k + 1) * nprimes * big_n * logn // 2
    # per member: external product (k+1)^2*l products + monomial weight
    pointwise = ell * big_n * nprimes * ((k + 1) * (k + 1) * l + (k + 1))
    per_block = (fwd + inv) * 14 + pointwise * 11 + big_n * 40
    ops = d * per_block
    tail = k * big_n - d * ell  # coefficients beyond the free head
    ks_macs = 4 * tail * params.f * (1 << (params.log_d - 1)) * (d * ell + 1)
    brk_bytes = d * ell * (k + 1) * l * (k + 1) * nprimes * big_n * 4 * 2
    return BootstrapCost(
        ntt_elems=d * (fwd + inv) * 2,
        int_ops=ops,
        int8_macs=ks_macs,
        key_bytes=brk_bytes,
    )


def ccs_cost(params, nprimes: int = 2) -> BootstrapCost:
    """Per-gate cost of a CCS hybrid-product bootstrap
    (bootstrapping.jl:234-328): for party index idx (1-based), each of n
    steps decomposes idx+1 components (l digits each), forward-transforms
    them twice (acc digits, then v digits), computes u/v/w pointwise, and
    inverse-transforms v (idx+1) and the output (idx+1)."""
    n, big_n, k, l = params.n, params.big_n, params.k, params.l_uni
    logn = int(math.log2(big_n))
    ops = 0
    ntt_elems = 0
    for idx in range(1, k + 1):
        comps = idx + 1
        fwd = 2 * comps * l * nprimes * big_n * logn // 2  # acc + v digits
        inv = 2 * comps * nprimes * big_n * logn // 2  # v + output
        # u: comps*l products; v: comps*l; w: 2*comps*l (b and a rows)
        pointwise = big_n * nprimes * (4 * comps * l + 2)
        ops += n * ((fwd + inv) * 14 + pointwise * 11 + big_n * 40)
        ntt_elems += n * (fwd + inv) * 2
    ks_macs = 4 * k * big_n * params.f * (1 << (params.log_d - 1)) * (n + 1)
    brk_bytes = k * n * l * 3 * nprimes * big_n * 4 * 2  # d + f stacks
    return BootstrapCost(
        ntt_elems=ntt_elems,
        int_ops=ops,
        int8_macs=ks_macs,
        key_bytes=brk_bytes,
    )


def cggi_cost(params, nprimes: int = 2) -> BootstrapCost:
    """Per-gate cost of a CGGI bootstrap (see SURVEY.md section 3.3)."""
    n, big_n, k, l = params.n, params.big_n, params.k, params.l_gsw
    logn = int(math.log2(big_n))
    fwd = (k + 1) * l * nprimes * big_n * logn  # butterfly elements
    inv = (k + 1) * nprimes * big_n * logn
    pointwise = big_n * nprimes * (k + 1) * (k + 1) * l
    per_step = (fwd + inv) // 2 * 14 + pointwise * 16
    ops = n * per_step
    ks_macs = 4 * (k * big_n * params.f) * (n + 1)
    brk_bytes = n * (k + 1) * l * (k + 1) * nprimes * big_n * 4 * 2
    return BootstrapCost(
        ntt_elems=n * (fwd + inv),
        int_ops=ops,
        int8_macs=ks_macs,
        key_bytes=brk_bytes,
    )
