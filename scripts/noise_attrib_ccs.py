"""Fine-grained CCS noise attribution: separate sigmas for the public key
(gen_b), the UniEnc d-vector, and the UniEnc f-RLEV, to identify which
hybrid-product noise term dominates the blind-rotation error.

Usage: python scripts/noise_attrib_ccs.py <preset> [batch]
"""

import functools
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from mktfhe.ciphertext.keys import binary_lwe_key, binary_ring_key, ternary_ring_key
from mktfhe.ciphertext.rlwe import gadget_gvec, rlev_encrypt
from mktfhe.ciphertext.unienc import UniEnc, gen_b, _mul_ring_key
from mktfhe.ring.sampler import gaussian_torus
from mktfhe.schemes import ccs
from mktfhe.schemes.common import build_ksk
from mktfhe.schemes.gates import gate_affine, lwe_decrypt_bit_mk, lwe_ith_encrypt_bit
from mktfhe.schemes.presets import ALL_PRESETS
from mktfhe.utils.noise import noise_report


def unienc_encrypt_s(rng, msg, crs, key, s_d, s_f, l, log_b, ctx):
    k_r, k_d, k_f = jax.random.split(rng, 3)
    r = ternary_ring_key(k_r, 1, ctx)
    gvec = gadget_gvec(l, log_b, ctx.dtype)
    msg = jnp.asarray(msg, dtype=ctx.dtype)
    msgpoly = jnp.zeros((l, ctx.n), ctx.dtype).at[:, 0].set(gvec * msg)
    e = gaussian_torus(k_d, (l, ctx.n), s_d, ctx.dtype)
    d = _mul_ring_key(crs, r, ctx) + msgpoly + e
    f = rlev_encrypt(k_f, r.key[0], 0, key, s_f, l, log_b, ctx)
    return UniEnc(d=d, f=f)


@functools.partial(jax.jit, static_argnames=("params", "s_b", "s_d", "s_f"))
def party_keygen_s(rng, crs_polys, params, s_b, s_d, s_f):
    ctx = ccs._ctx(params)
    k_lwe, k_ring, k_b, k_brk, k_ksk = jax.random.split(rng, 5)
    lwe_key = binary_lwe_key(k_lwe, params.n, jnp.uint32)
    ring_key = binary_ring_key(k_ring, 1, ctx)
    pub_b = gen_b(k_b, crs_polys, ring_key, s_b, ctx)
    rngs = jax.random.split(k_brk, params.n)
    uni = jax.vmap(
        lambda r, bit: unienc_encrypt_s(
            r, bit, crs_polys, ring_key, s_d, s_f, params.l_uni, params.log_b_uni, ctx
        )
    )(rngs, lwe_key.key)
    ksk_b, ksk_a = build_ksk(
        k_ksk, ring_key.key[0], lwe_key, params.f, params.log_d, 0.0
    )
    return lwe_key, ring_key, ccs.CcsPartyKey(
        pub_b=pub_b, brk_d=uni.d, brk_f=uni.f, ksk_b=ksk_b, ksk_a=ksk_a
    )


def run(name, batch, s_b, s_d, s_f):
    params = ALL_PRESETS[name]
    rng = np.random.default_rng(7)
    m1 = rng.integers(0, 2, batch).astype(bool)
    m2 = rng.integers(0, 2, batch).astype(bool)
    want = ~(m1 & m2)
    k = params.k
    a = ccs.crs(jax.random.key(0), params)
    parties = [
        party_keygen_s(jax.random.key(1 + i), a, params, s_b, s_d, s_f)
        for i in range(k)
    ]
    keys = [p[0] for p in parties]
    scheme = ccs.setup(a, [p[2] for p in parties], params)
    ct1 = lwe_ith_encrypt_bit(jax.random.key(101), jnp.array(m1), 0, keys[0], 0.0, k, (batch,))
    ct2 = lwe_ith_encrypt_bit(jax.random.key(102), jnp.array(m2), 1, keys[1], 0.0, k, (batch,))
    out = ccs.bootstrap(gate_affine(0, ct1, ct2), scheme, params)
    return noise_report(out, keys, want)


def main():
    name = sys.argv[1]
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    beta = ALL_PRESETS[name].beta
    for tag, sigs in [
        ("pub_b only", (beta, 0.0, 0.0)),
        ("d only", (0.0, beta, 0.0)),
        ("f only", (0.0, 0.0, beta)),
        ("none (rounding)", (0.0, 0.0, 0.0)),
    ]:
        t0 = time.time()
        rep = run(name, batch, *sigs)
        print(
            json.dumps(
                {
                    "case": tag,
                    "std_bits": round(rep["std_bits"], 2),
                    "margin_sigmas": round(rep["margin_sigmas"], 1),
                    "s": round(time.time() - t0, 1),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
