"""Multi-device mesh tests on the 8-way virtual CPU mesh (SURVEY.md sec 4d)."""

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from mktfhe.schemes.params import KmsBlockParams

# block-binary counterparts of graft's tiny presets (n = d * ell = 8)
_BLOCK = dict(
    d=4, ell=2, alpha=float(1 << 17), f=8, log_d=2, big_n=64, beta=4.0,
    l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8,
)
TINY = {"binary": graft._TINY_PARAMS, "block": KmsBlockParams(**_BLOCK, k=2)}
TINY8 = {"binary": graft._TINY8_PARAMS, "block": KmsBlockParams(**_BLOCK, k=8)}
variants = pytest.mark.parametrize("variant", ["binary", "block"])


def test_dryrun_multichip():
    graft.dryrun_multichip(8)


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.b.shape[0] == 4


@variants
def test_sharded_matches_single_device(variant):
    """The party/batch-sharded KMS bootstrap must be bit-identical to the
    single-device path (same exact integer arithmetic, different layout)."""
    from mktfhe.parallel import kms_bootstrap_sharded, make_mesh, shard_scheme
    from mktfhe.schemes import kms

    params = TINY[variant]
    ct, scheme = graft._make_inputs(params, g=4)
    ref = kms.bootstrap(ct, scheme, params)

    mesh = make_mesh(2, 4)
    sh = shard_scheme(scheme, mesh)
    out = kms_bootstrap_sharded(ct, sh, params, mesh)
    np.testing.assert_array_equal(np.asarray(out.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(out.a), np.asarray(ref.a))


@variants
def test_shardmap_matches_single_device(variant):
    """Explicit shard_map phase 1 + all_gather: bit-identical too.

    g=4 on a (2,4) mesh leaves one local gate per batch shard, which does
    not divide by the party axis -- exercises the replicated-phase-2
    fallback."""
    from mktfhe.parallel import kms_bootstrap_shardmap, make_mesh, shard_scheme
    from mktfhe.schemes import kms

    params = TINY[variant]
    ct, scheme = graft._make_inputs(params, g=4)
    ref = kms.bootstrap(ct, scheme, params)

    mesh = make_mesh(2, 4)
    sh = shard_scheme(scheme, mesh)
    out = kms_bootstrap_shardmap(ct, sh, params, mesh)
    np.testing.assert_array_equal(np.asarray(out.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(out.a), np.asarray(ref.a))


@variants
def test_shardmap_gate_split_phase2(variant):
    """g=16 on a (2,4) mesh: 4 local gates split 2-ways across the party
    axis in phase 2 (the non-replicated merge), still bit-identical."""
    from mktfhe.parallel import kms_bootstrap_shardmap, make_mesh, shard_scheme
    from mktfhe.schemes import kms

    params = TINY[variant]
    ct, scheme = graft._make_inputs(params, g=16)
    ref = kms.bootstrap(ct, scheme, params)

    mesh = make_mesh(2, 4)
    sh = shard_scheme(scheme, mesh)
    out = kms_bootstrap_shardmap(ct, sh, params, mesh)
    np.testing.assert_array_equal(np.asarray(out.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(out.a), np.asarray(ref.a))


def test_shardmap_party_only_mesh():
    """A party-only mesh (no batch axis) is valid (ADVICE round 2, #2)."""
    from jax.sharding import Mesh
    from mktfhe.parallel import kms_bootstrap_shardmap, shard_scheme, make_mesh
    from mktfhe.schemes import kms

    params = graft._TINY_PARAMS
    ct, scheme = graft._make_inputs(params, g=4)
    ref = kms.bootstrap(ct, scheme, params)

    mesh = Mesh(np.array(jax.devices()[:2]), ("party",))
    sh = shard_scheme(scheme, make_mesh(2, 1))
    out = kms_bootstrap_shardmap(ct, sh, params, mesh)
    np.testing.assert_array_equal(np.asarray(out.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(out.a), np.asarray(ref.a))


@variants
def test_shardmap_sharded_phase2(variant):
    """Party-sharded phase-2 residency (the PARALLEL.md k=32 plan, at k=8
    tiny on a (party=4, batch=2) mesh, 2 parties per device): rlk/pub/ksk
    live sharded, the owner psum-broadcasts its rlk rows per merge step,
    and the key switch reassembles from party-partials (psum b, concat a).
    Bit-identical to the replicated single-device path."""
    from mktfhe.parallel import kms_bootstrap_shardmap, make_mesh, shard_scheme
    from mktfhe.schemes import kms

    params = TINY8[variant]
    ct, scheme = graft._make_inputs(params, g=8)
    ref = kms.bootstrap(ct, scheme, params)

    mesh = make_mesh(4, 2)
    sh = shard_scheme(scheme, mesh)
    out = kms_bootstrap_shardmap(ct, sh, params, mesh, shard_phase2=True)
    np.testing.assert_array_equal(np.asarray(out.b), np.asarray(ref.b))
    np.testing.assert_array_equal(np.asarray(out.a), np.asarray(ref.a))
