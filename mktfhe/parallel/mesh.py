"""Multi-chip sharding for multi-key bootstrapping.

The reference's only parallelism is shared-memory threading: KMS phase 1
spawns one task per party (/root/reference/src/tfhe/bootstrapping.jl:376-378)
and key switching threads over parties (:573).  JAX equivalent: a
device mesh with a `party` axis (each party's bootstrapping key resident on
its own device group -- phase 1 needs zero communication, the scheme's
structural gift) and a `batch` axis for gate-level data parallelism.

XLA's SPMD partitioner inserts the collectives: the per-party lev keys are
all-gathered (small: l_lev * 2 * nprimes * N residues per party per gate)
for the sequential phase-2 merge, and the per-party key-switch partial b's
reduce with a psum (the reference's racy `res.b +=` at :591).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ciphertext.lwe import Lwe
from ..ring.context import make_ring_ctx
from ..schemes import kms
from ..schemes.common import initial_acc, mod_switch_2n
from ..schemes.params import KmsBlockParams


def make_mesh(n_party: int, n_batch: int) -> Mesh:
    devs = jax.devices()[: n_party * n_batch]
    import numpy as np

    return Mesh(np.array(devs).reshape(n_party, n_batch), ("party", "batch"))


def shard_scheme(scheme: kms.KmsScheme, mesh: Mesh) -> kms.KmsScheme:
    """Place per-party key material on the party axis; replicate the rest."""
    party0 = NamedSharding(mesh, P("party"))
    repl = NamedSharding(mesh, P())
    per_party = {
        "pub_b_hat", "pub_b_shoup", "brk_hat", "brk_shoup",
        "rlk_d_hat", "rlk_d_shoup", "rlk_f_hat", "rlk_f_shoup",
        "ksk_b", "ksk_a",
    }
    out = {}
    for name in scheme.__dataclass_fields__:
        arr = getattr(scheme, name)
        sh = party0 if name in per_party and arr.ndim > 0 and arr.shape[0] else repl
        out[name] = jax.device_put(arr, sh)
    return kms.KmsScheme(**out)


@functools.partial(jax.jit, static_argnames=("params", "mesh"))
def _bootstrap_sharded(ct: Lwe, scheme: kms.KmsScheme, params, mesh) -> Lwe:
    ctx = make_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)
    k = params.k
    tildeb, tildea = mod_switch_2n(ct, params.big_n)
    g = tildea.shape[0]
    tild = tildea.reshape(g, k, params.n)

    batch_sh = NamedSharding(mesh, P(None, "batch"))
    is_block = isinstance(params, KmsBlockParams)

    # phase 1, uniform l_lev rows for every party so the party axis vmaps
    # (party 1's extra rows are redundant but harmless; phase 2 uses only
    # row 0 for it, matching bootstrapping.jl:400's iter=1 special case).
    def p1(ta_p, brk_h, brk_s):
        if is_block:
            return kms.phase1_block(
                ta_p, brk_h, brk_s, params.l_lev, scheme, params, ctx
            )
        return kms.phase1(ta_p, brk_h, brk_s, params.l_lev, params, ctx)

    tild_pm = jnp.moveaxis(tild, 1, 0)  # [k, G, n]
    levkeys = jax.vmap(p1)(tild_pm, scheme.brk_hat, scheme.brk_shoup)
    levkeys = jax.lax.with_sharding_constraint(
        levkeys, NamedSharding(mesh, P("party", "batch"))
    )

    acc = initial_acc(tildeb, params.big_n, k, ctx.dtype)
    for p1_idx in range(1, k + 1):
        iter_rows = 1 if p1_idx == 1 else params.l_lev
        lk = levkeys[p1_idx - 1][:, :iter_rows]
        acc = kms._phase2_party(acc, lk, p1_idx, scheme, params, ctx)
        acc = jax.lax.with_sharding_constraint(
            acc, NamedSharding(mesh, P("batch"))
        )
    out = kms._keyswitch(acc, scheme, params)
    return Lwe(
        b=jax.lax.with_sharding_constraint(out.b, NamedSharding(mesh, P("batch"))),
        a=jax.lax.with_sharding_constraint(out.a, batch_sh),
    )


def kms_bootstrap_sharded(ct: Lwe, scheme: kms.KmsScheme, params, mesh: Mesh) -> Lwe:
    """Multi-key gate bootstrap over a (party, batch) device mesh."""
    return _bootstrap_sharded(ct, scheme, params, mesh)
