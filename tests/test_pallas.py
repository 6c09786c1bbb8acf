"""Pallas NTT kernel (Triton route) vs the jnp reference transform.

On the CPU the kernel runs in interpret mode; the `gpu` cases compile it
for the card.  Exact integers, so every comparison is bit-for-bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe.kernels.ntt_pallas import fwd_ntt_pallas, inv_ntt_pallas
from mktfhe.ring import fwd_ntt, inv_ntt, make_plan

_PAIRS = {True: (fwd_ntt_pallas, fwd_ntt), False: (inv_ntt_pallas, inv_ntt)}


def _residues(lead, plan, seed=5):
    rng = np.random.default_rng(seed)
    p = plan.primes.astype(np.uint64)[:, None]
    x = rng.integers(0, 1 << 32, size=(*lead, plan.nprimes, plan.n), dtype=np.uint64)
    return (x % p).astype(np.uint32)


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("npr", [2, 3, 4])
@pytest.mark.parametrize("n", [64, 256, 1024, 2048])
def test_pallas_ntt_matches_jnp(n, npr, forward):
    plan = make_plan(n, npr)
    x = jnp.asarray(_residues((2,), plan))
    kernel, ref = _PAIRS[forward]
    got = kernel(x, plan, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref(x, plan)))


@pytest.mark.parametrize("lead", [(), (3,), (2, 3, 1)], ids=["none", "odd", "nested"])
def test_pallas_ntt_roundtrip_shapes(lead):
    """Any leading shape (odd row counts use one row per program) comes back
    unchanged through forward then inverse."""
    plan = make_plan(128, 3)
    x = jnp.asarray(_residues(lead, plan, seed=11))
    y = fwd_ntt_pallas(x, plan, interpret=True)
    assert y.shape == x.shape and y.dtype == jnp.uint32
    back = inv_ntt_pallas(y, plan, interpret=True)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_pallas_ntt_edge_residues():
    """0 and p-1 in every slot: the lazy-free butterflies stay canonical."""
    plan = make_plan(256, 4)
    top = np.broadcast_to((plan.primes - 1)[:, None], (4, 256))
    x = jnp.asarray(np.stack([np.zeros_like(top), top]).astype(np.uint32))
    for kernel, ref in _PAIRS.values():
        got = kernel(x, plan, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref(x, plan)))


@pytest.mark.gpu
@pytest.mark.parametrize("npr", [3, 4])
def test_pallas_ntt_compiled_on_gpu(gpu_device, npr):
    """The kernel as compiled for the card, at N=2048, bit-identical."""
    plan = make_plan(2048, npr)
    x = jax.device_put(_residues((16, 3), plan), gpu_device)
    for forward, (kernel, ref) in _PAIRS.items():
        got = jax.jit(lambda a: kernel(a, plan))(x)
        want = jax.jit(lambda a: ref(a, plan))(x)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(forward))
