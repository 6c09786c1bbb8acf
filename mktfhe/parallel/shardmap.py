"""Explicit shard_map multi-key bootstrap: party-sharded phase 1,
gate-split phase 2.

Alternative to parallel/mesh.py's partitioner-driven path, with the
communication pattern written out explicitly (SURVEY.md section 5,
"distributed communication backend"):

  * phase 1: `shard_map` over the ('party', 'batch') mesh -- zero
    communication (the reference's `@spawn` per party,
    /root/reference/src/tfhe/bootstrapping.jl:376-378).
  * phase boundary: one all_gather of the per-party lev keys over the
    `party` axis -- l_lev * 2 * nprimes * N u32 words per party per local
    gate.
  * phase 2 + key switch: the sequential k-party merge is per-gate
    independent, so the devices along the party axis split the local gate
    batch between them (device p takes gates [p*Gs, (p+1)*Gs)) instead of
    replicating the merge; a second all_gather over `party` reassembles the
    batch.  Net: phase 2 runs on all party*batch devices at 1/(P*B) of the
    gates each.  Falls back to the replicated merge when the local batch
    does not divide by the party-axis size.

Bit-identical to the single-device path (tests/test_parallel.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ciphertext.lwe import Lwe
from ..ring.context import make_ring_ctx
from ..schemes import kms
from ..schemes.common import initial_acc, mod_switch_2n
from ..schemes.params import KmsBlockParams


def _phase1_fn(params, ctx, pallas_ntt: bool, interpret: bool, scheme):
    """Per-party phase-1 callable (ta [G,n], brk_h, brk_s) -> lev key."""
    if isinstance(params, KmsBlockParams):
        return lambda ta, bh, bs: kms.phase1_block(
            ta, bh, bs, params.l_lev, scheme, params, ctx, pallas_ntt, interpret
        )
    return lambda ta, bh, bs: kms.phase1(
        ta, bh, bs, params.l_lev, params, ctx, pallas_ntt, interpret
    )


@functools.partial(
    jax.jit, static_argnames=("params", "mesh", "pallas_ntt", "interpret")
)
def _bootstrap_shardmap(ct, scheme, params, mesh, pallas_ntt, interpret, brk_h, brk_s):
    ctx = make_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)
    k = params.k
    n_party = mesh.shape["party"]
    n_batch = mesh.shape.get("batch", 1)  # party-only meshes are valid
    has_batch = "batch" in mesh.shape
    tildeb, tildea = mod_switch_2n(ct, params.big_n)
    g = tildea.shape[0]
    tild = jnp.moveaxis(tildea.reshape(g, k, params.n), 1, 0)  # [k, G, n]
    g_local = g // n_batch
    split_p2 = g_local % n_party == 0

    def body(tb_l, ta_l, brk_h_l, brk_s_l, scheme_r):
        p1_fn = _phase1_fn(params, ctx, pallas_ntt, interpret, scheme_r)
        # ta_l: [k/P, Gl, n]; tb_l: [Gl]; python loop over resident parties
        local = jnp.stack(
            [p1_fn(ta_l[i], brk_h_l[i], brk_s_l[i]) for i in range(ta_l.shape[0])]
        )  # [k/P, Gl, l_lev, 2, npr, N]
        # phase boundary: every party's lev key to every device
        lev = jax.lax.all_gather(local, "party", axis=0, tiled=True)  # [k, Gl, ...]

        if split_p2:
            # split the local gates across the party-axis devices
            gs = g_local // n_party
            pidx = jax.lax.axis_index("party")
            lev = jax.lax.dynamic_slice_in_dim(lev, pidx * gs, gs, axis=1)
            tb = jax.lax.dynamic_slice_in_dim(tb_l, pidx * gs, gs, axis=0)
        else:
            tb = tb_l

        acc = initial_acc(tb, params.big_n, k, ctx.dtype)
        for p1 in range(1, k + 1):
            iter_rows = 1 if p1 == 1 else params.l_lev
            acc = kms._phase2_party(
                acc, lev[p1 - 1][:, :iter_rows], p1, scheme_r, params, ctx,
                pallas_ntt=pallas_ntt, interpret=interpret,
            )
        out = kms._keyswitch(acc, scheme_r, params)
        if split_p2:
            # reassemble the gate batch from the party-axis split
            b = jax.lax.all_gather(out.b, "party", axis=0, tiled=True)
            a = jax.lax.all_gather(out.a, "party", axis=0, tiled=True)
            return b, a
        return out.b, out.a

    bax = "batch" if has_batch else None
    b, a = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(bax), P("party", bax), P("party"), P("party"), P()),
        out_specs=(P(bax), P(bax)),
        check_vma=False,
    )(tildeb, tild, brk_h, brk_s, scheme)
    return Lwe(b=b, a=a)


@functools.partial(
    jax.jit, static_argnames=("params", "mesh", "pallas_ntt", "interpret")
)
def _bootstrap_shardmap_p2sharded(ct, scheme_core, params, mesh, pallas_ntt, interpret, brk_h, brk_s):
    """Party-sharded phase-2 residency (the PARALLEL.md k=32 plan).

    rlk/pub_b/ksk live party-sharded (k/P parties per device).  Per merge
    step, the owning device broadcasts that party's rlk rows via a masked
    psum (~l_uni*npr*N words); the public keys are all-gathered once (the
    smallest table -- later steps need ALL earlier parties' pub rows);
    the key switch runs party-partial on each device and reassembles with
    the reference's own pattern (psum of partial b's, concatenation of
    disjoint a segments, bootstrapping.jl:340-363,571-593).  Bit-identical
    to the replicated path (tests/test_parallel.py).
    """
    ctx = make_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)
    k = params.k
    n_batch = mesh.shape.get("batch", 1)
    has_batch = "batch" in mesh.shape
    tildeb, tildea = mod_switch_2n(ct, params.big_n)
    g = tildea.shape[0]
    tild = jnp.moveaxis(tildea.reshape(g, k, params.n), 1, 0)  # [k, G, n]

    # party-sharded phase-2 material (stripped from the replicated scheme)
    rd_h, rd_s = scheme_core.rlk_d_hat, scheme_core.rlk_d_shoup
    rf_h, rf_s = scheme_core.rlk_f_hat, scheme_core.rlk_f_shoup
    pub_h, pub_s = scheme_core.pub_b_hat, scheme_core.pub_b_shoup
    ksk_b, ksk_a = scheme_core.ksk_b, scheme_core.ksk_a
    z = jnp.zeros((0,), dtype=jnp.uint32)
    scheme_r = dataclasses.replace(
        scheme_core, rlk_d_hat=z, rlk_d_shoup=z, rlk_f_hat=z, rlk_f_shoup=z,
        pub_b_hat=z, pub_b_shoup=z, ksk_b=z, ksk_a=z,
    )

    def body(tb_l, ta_l, brk_h_l, brk_s_l, scheme_rep,
             rd_l, rds_l, rf_l, rfs_l, pub_l, pubs_l, kb_l, ka_l):
        from ..ciphertext.decomp import balanced_decomp
        from ..schemes.common import sample_extract_coeffs, signed_onehot

        p1_fn = _phase1_fn(params, ctx, pallas_ntt, interpret, scheme_rep)
        local = jnp.stack(
            [p1_fn(ta_l[i], brk_h_l[i], brk_s_l[i]) for i in range(ta_l.shape[0])]
        )
        lev = jax.lax.all_gather(local, "party", axis=0, tiled=True)

        kp = rd_l.shape[0]  # parties resident on this device
        pidx = jax.lax.axis_index("party")

        def bcast(x_l, pi: int):
            """Masked-psum broadcast of party pi's slice from its owner."""
            owner, li = divmod(pi, kp)
            sl = x_l[li]
            return jax.lax.psum(
                jnp.where(pidx == owner, sl, jnp.zeros_like(sl)), "party"
            )

        # pub_b is the smallest table and later steps need all earlier
        # parties' rows: one all_gather up front
        pub_fh = jax.lax.all_gather(pub_l, "party", axis=0, tiled=True)
        pub_fs = jax.lax.all_gather(pubs_l, "party", axis=0, tiled=True)

        acc = initial_acc(tb_l, params.big_n, k, ctx.dtype)
        for p1 in range(1, k + 1):
            iter_rows = 1 if p1 == 1 else params.l_lev
            acc = kms._phase2_party_mat(
                acc, lev[p1 - 1][:, :iter_rows], p1,
                bcast(rd_l, p1 - 1), bcast(rds_l, p1 - 1),
                bcast(rf_l, p1 - 1), bcast(rfs_l, p1 - 1),
                pub_fh[: p1 - 1], pub_fs[: p1 - 1],
                scheme_rep.crs_hat, scheme_rep.crs_shoup,
                params, ctx, pallas_ntt=pallas_ntt, interpret=interpret,
            )

        # party-partial key switch (modswitch 64->32 first)
        acc32 = (acc >> 32).astype(jnp.uint32)
        b0 = acc32[:, 0, 0]
        own = jax.lax.dynamic_slice_in_dim(acc32[:, 1:], pidx * kp, kp, axis=1)
        arr = sample_extract_coeffs(own)  # [Gl, kp, N]
        is_block = isinstance(params, KmsBlockParams)
        if is_block:  # the first n coefficients pass for free (kms._keyswitch)
            free, arr = arr[..., : params.n], arr[..., params.n :]
        digits = balanced_decomp(arr, params.f, params.log_d)
        oh = signed_onehot(digits, params.log_d)
        flat = oh.reshape(*oh.shape[:-2], -1)  # [Gl, kp, R]
        outb = jnp.zeros(flat.shape[:-1], dtype=jnp.int32)
        outa = None
        for limb in range(kb_l.shape[1]):
            pb = jnp.einsum(
                "gkr,kr->gk", flat, kb_l[:, limb], preferred_element_type=jnp.int32
            )
            pa = jnp.einsum(
                "gkr,krn->gkn", flat, ka_l[:, limb], preferred_element_type=jnp.int32
            )
            outb = outb + (pb << (8 * limb))
            outa = (pa << (8 * limb)) if outa is None else outa + (pa << (8 * limb))
        u32c = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
        b = b0 + jax.lax.psum(
            jnp.sum(u32c(outb), axis=-1, dtype=jnp.uint32), "party"
        )
        a_local = u32c(outa) + free if is_block else u32c(outa)
        a_local = a_local.reshape(arr.shape[0], -1)  # [Gl, kp*n]
        a = jax.lax.all_gather(a_local, "party", axis=1, tiled=True)  # [Gl, k*n]
        return b, a

    bax = "batch" if has_batch else None
    b, a = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(bax), P("party", bax), P("party"), P("party"), P(),
            P("party"), P("party"), P("party"), P("party"),
            P("party"), P("party"), P("party"), P("party"),
        ),
        out_specs=(P(bax), P(bax)),
        check_vma=False,
    )(tildeb, tild, brk_h, brk_s, scheme_r,
      rd_h, rd_s, rf_h, rf_s, pub_h, pub_s, ksk_b, ksk_a)
    return Lwe(b=b, a=a)


def kms_bootstrap_shardmap(ct: Lwe, scheme: kms.KmsScheme, params, mesh: Mesh, pallas_ntt: bool = False, interpret: bool = False, shard_phase2: bool = False) -> Lwe:
    """KMS gate bootstrap with explicit shard_map over a (party, batch) mesh.

    Requires mesh axis 'party' with size dividing k; a 'batch' axis is
    optional.  pallas_ntt routes phase 1's and phase 2's NTTs through the
    Pallas kernels, as in kms.bootstrap.

    shard_phase2=True additionally party-shards the phase-2 key material
    (rlk, pub_b, ksk) instead of replicating it -- the k=32 residency
    plan (PARALLEL.md): per merge step the owner broadcasts its party's
    rlk rows (masked psum), and the key switch runs party-partial with a
    psum of b and concatenation of a segments.
    """
    # phase 2 never touches scheme.brk_*; strip the largest key material
    # from the replicated operand so an all-gather of it is impossible
    # regardless of XLA dead-code elimination (brk reaches phase 1 via the
    # party-sharded brk operands).
    z = jnp.zeros((0,), dtype=jnp.uint32)
    replicated = dataclasses.replace(scheme, brk_hat=z, brk_shoup=z)
    fn = _bootstrap_shardmap_p2sharded if shard_phase2 else _bootstrap_shardmap
    return fn(
        ct, replicated, params, mesh, pallas_ntt, interpret,
        scheme.brk_hat, scheme.brk_shoup,
    )
