"""Pallas (Triton route) negacyclic NTT: all log2(N) stages on chip.

`ring/ntt.py` runs each butterfly stage as its own reshape/stack, which XLA
materialises in device memory: one round trip per stage.  Here one program
owns `rows` residue polynomials of one CRT prime (N u32 each, 8 KB at
N=2048), loads them once, runs every stage in registers and shared memory,
and stores once.  A stage splits the [rows, m, 2t] view into its two halves
(`lax.split`), applies the butterfly, and interleaves the results back
(stack on a trailing axis + transpose), which is what the Triton lowering
can express; `lax.slice` it cannot.

The Shoup product takes its quotient from the card's native 32x32->64
multiply (a u64 product and a shift) instead of `ring/modring.mulhi_u32`'s
four 16-bit partial products.  Same merged-twist CT/GS formulation and the
same canonical residues after every stage as `ring/ntt.py`, so outputs are
bit-identical (tests/test_pallas.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..ring.ntt import NttPlan, make_plan

U32 = jnp.uint32
U64 = jnp.uint64
MAX_ROWS = 2  # residue polynomials per program


def _shoup(w, w_sh, a, p):
    q = ((w_sh.astype(U64) * a.astype(U64)) >> 32).astype(U32)
    r = w * a - q * p  # wrapping u32; in [0, 2p)
    return jnp.where(r >= p, r - p, r)


def _addmod(a, b, p):
    s = a + b
    return jnp.where(s >= p, s - p, s)


def _submod(a, b, p):
    d = a + (p - b)
    return jnp.where(d >= p, d - p, d)


def _interleave(hi, lo, rows: int, n: int):
    """[rows, m, t] halves -> [rows, m, 2, t] -> [rows, n]."""
    x = jnp.stack([hi, lo], axis=-1)  # [rows, m, t, 2]
    return jnp.swapaxes(x, -1, -2).reshape(rows, n)


def _kernel(c_ref, tw_ref, twsh_ref, x_ref, o_ref, *, n: int, forward: bool):
    p = c_ref[0]
    a = x_ref[...]  # [rows, n]
    rows = a.shape[0]
    if forward:  # Cooley-Tukey, natural -> bit-reversed (ring/ntt.fwd_ntt)
        m, t = 1, n
        while m < n:
            t //= 2
            w = tw_ref[pl.ds(m, m)].reshape(1, m, 1)
            ws = twsh_ref[pl.ds(m, m)].reshape(1, m, 1)
            u, v = jnp.split(a.reshape(rows, m, 2 * t), 2, axis=2)
            vw = _shoup(w, ws, v, p)
            a = _interleave(_addmod(u, vw, p), _submod(u, vw, p), rows, n)
            m *= 2
    else:  # Gentleman-Sande, bit-reversed -> natural (ring/ntt.inv_ntt)
        m, t = n, 1
        while m > 1:
            h = m // 2
            w = tw_ref[pl.ds(h, h)].reshape(1, h, 1)
            ws = twsh_ref[pl.ds(h, h)].reshape(1, h, 1)
            u, v = jnp.split(a.reshape(rows, h, 2 * t), 2, axis=2)
            lo = _shoup(w, ws, _submod(u, v, p), p)
            a = _interleave(_addmod(u, v, p), lo, rows, n)
            t *= 2
            m = h
        a = _shoup(c_ref[1], c_ref[2], a, p)
    o_ref[...] = a


@functools.lru_cache(maxsize=None)
def _tables(n: int, nprimes: int, forward: bool):
    """Per-prime constants [npr, 4] = (p, N^-1, shoup(N^-1), 0) and the
    twiddle tables of the direction."""
    plan = make_plan(n, nprimes)
    consts = np.stack(
        [plan.primes, plan.n_inv, plan.n_inv_shoup, np.zeros_like(plan.primes)],
        axis=1,
    ).astype(np.uint32)
    if forward:
        return consts, plan.psi_brv, plan.psi_brv_shoup
    return consts, plan.ipsi_brv, plan.ipsi_brv_shoup


def _transform(a, plan: NttPlan, forward: bool, interpret: bool):
    npr, n = plan.nprimes, plan.n
    assert a.shape[-2:] == (npr, n), (a.shape, npr, n)
    lead = a.shape[:-2]
    r = math.prod(lead)
    rows = math.gcd(r, MAX_ROWS)
    x = a.reshape(r, npr, n)
    consts, tw, tw_sh = _tables(n, npr, forward)
    table = pl.BlockSpec((None, n), lambda i, q: (q, 0))
    y = pl.pallas_call(
        functools.partial(_kernel, n=n, forward=forward),
        out_shape=jax.ShapeDtypeStruct(x.shape, U32),
        grid=(r // rows, npr),
        in_specs=[
            pl.BlockSpec((None, 4), lambda i, q: (q, 0)),
            table,
            table,
            pl.BlockSpec((rows, None, n), lambda i, q: (i, q, 0)),
        ],
        out_specs=pl.BlockSpec((rows, None, n), lambda i, q: (i, q, 0)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ntt_fwd" if forward else "ntt_inv",
    )(jnp.asarray(consts), jnp.asarray(tw), jnp.asarray(tw_sh), x)
    return y.reshape(a.shape)


def fwd_ntt_pallas(a, plan: NttPlan, interpret: bool = False):
    """Drop-in for ring.ntt.fwd_ntt on [..., nprimes, N] uint32."""
    return _transform(jnp.asarray(a, U32), plan, True, interpret)


def inv_ntt_pallas(a, plan: NttPlan, interpret: bool = False):
    """Drop-in for ring.ntt.inv_ntt on [..., nprimes, N] uint32."""
    return _transform(jnp.asarray(a, U32), plan, False, interpret)
