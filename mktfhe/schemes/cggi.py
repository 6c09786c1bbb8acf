"""CGGI16 single-key gate bootstrapping.

Counterpart of the CGGI pieces of the reference: scheme object + setup
(/root/reference/src/tfhe/scheme.jl:107-166), bootstrapping key
(keygen.jl:3-27), blind rotation (bootstrapping.jl:32-76) and key switch
(bootstrapping.jl:81-109).

Redesign for batched exact arithmetic:
  * brk is one stacked tensor [n, cin, l, cout, nprimes, N] in the NTT
    domain (plus Shoup companion), not n RGSW objects.
  * The n-step rotation is a lax.scan whose xs stream the per-bit brk
    slices; everything inside a step is batched over the gate axis.
  * The monomial multiply (X^a - 1) is a coefficient-domain negacyclic
    roll, so the 2N-entry monomial FFT table (scheme.jl:121-146) and the
    `tildea > 0` branch disappear (roll by 0 contributes exactly zero).
  * Key switch = int8 matmul (schemes/common.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..ciphertext.gsw import external_product_hat, rgsw_encrypt, rgsw_to_hat, rlwe_decomp_hat
from ..ciphertext.keys import binary_lwe_key, binary_ring_key
from ..ciphertext.lwe import Lwe
from ..ring.context import RingCtx, make_ring_ctx
from ..ring.sampler import rng_streams
from ..ring.ntt import inv_ntt
from ..ring.torus import from_crt, negacyclic_roll
from .common import initial_acc, keyswitch_table, mod_switch_2n, build_ksk
from .params import CggiParams

# top-level sampling streams consumed by keygen (ring/sampler.rng_streams)
KEYGEN_STREAMS = 4


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CggiScheme:
    """Runtime scheme state (reference CGGI struct, scheme.jl:107-116)."""

    brk_hat: jnp.ndarray  # [n, k+1, l, k+1, npr, N] uint32
    brk_shoup: jnp.ndarray
    ksk_b: jnp.ndarray  # [NLIMB, R] int8, R = k*N*f*D/2
    ksk_a: jnp.ndarray  # [NLIMB, R, n] int8


def _ctx(params: CggiParams) -> RingCtx:
    return make_ring_ctx(params.big_n, params.torus_bits, params.nprimes)


@functools.partial(jax.jit, static_argnames=("params",))
def setup(rng, params: CggiParams):
    """Keygen: (lwe_key, ring_key, scheme) -- scheme.jl:151-166.

    brk[i] = NTT(RGSW(s_i)) (keygen.jl:13-15, threaded there, vmapped
    here); ksk rows encrypt ring-key coefficients (keygen.jl:17-23,
    redesigned as matmul operands, see common.build_ksk).
    """
    ctx = _ctx(params)
    k_lwe, k_ring, k_brk, k_ksk = rng_streams(rng, KEYGEN_STREAMS)
    lwe_key = binary_lwe_key(k_lwe, params.n, jnp.uint32)
    ring_key = binary_ring_key(k_ring, params.k, ctx)

    rngs = jax.random.split(k_brk, params.n)
    brk = jax.vmap(
        lambda r, bit: rgsw_encrypt(
            r, bit, ring_key, params.beta, params.l_gsw, params.log_b_gsw, ctx
        )
    )(rngs, lwe_key.key)
    brk_hat, brk_shoup = rgsw_to_hat(brk, ctx)

    coeffs = ring_key.key.reshape(-1)  # [k*N] extraction-order targets
    ksk_b, ksk_a = build_ksk(k_ksk, coeffs, lwe_key, params.f, params.log_d, params.alpha)

    return lwe_key, ring_key, CggiScheme(
        brk_hat=brk_hat, brk_shoup=brk_shoup, ksk_b=ksk_b, ksk_a=ksk_a
    )


def blind_rotate(acc, tildea, scheme: CggiScheme, params: CggiParams, ctx: RingCtx):
    """n sequential CMux steps (bootstrapping.jl:32-76).

    acc: [G, k+1, N]; tildea: [G, n] values in [0, 2N).
    Step: decompose acc -> NTT -> external product with brk_i -> inverse
    NTT -> acc += X^{a_i} * e - e  (branchless: a_i = 0 contributes 0).
    """

    def step(acc, xs):
        brk_h, brk_s, ta = xs
        dhat = rlwe_decomp_hat(acc, params.l_gsw, params.log_b_gsw, ctx)
        ehat = external_product_hat(dhat, brk_h, brk_s, ctx)
        e = from_crt(inv_ntt(ehat, ctx.plan), ctx.crt, ctx.dtype)
        rolled = jax.vmap(negacyclic_roll)(e, ta.astype(jnp.int32))
        return acc + rolled - e, None

    acc, _ = jax.lax.scan(
        step, acc, (scheme.brk_hat, scheme.brk_shoup, tildea.T)
    )
    return acc


@functools.partial(jax.jit, static_argnames=("params",))
def bootstrap(ct: Lwe, scheme: CggiScheme, params: CggiParams) -> Lwe:
    """Gate bootstrap of a batch of LWE ciphertexts (bootstrapping.jl:4-27).

    ct: Lwe with b [G], a [G, n].
    """
    ctx = _ctx(params)
    tildeb, tildea = mod_switch_2n(ct, params.big_n)
    acc = initial_acc(tildeb, params.big_n, params.k, ctx.dtype)
    acc = blind_rotate(acc, tildea, scheme, params, ctx)
    return keyswitch_table(acc, scheme.ksk_b, scheme.ksk_a, params.f, params.log_d)
