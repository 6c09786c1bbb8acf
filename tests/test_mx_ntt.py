"""mx-NTT (matmul-factored negacyclic NTT): exactness of the jnp reference.

The mx transform must be the standard negacyclic NTT up to a fixed
permutation of evaluation points: we check the exact inverse property and
the convolution theorem against the round-1 exact pipeline (ring/ntt.py),
plus the direct brute-force DFT at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe.kernels.mx_ntt import (
    NK,
    from_mx_order,
    mx_fwd_ref,
    mx_inv_ref,
    mx_plan,
    to_mx_order,
)
from mktfhe.ring.modring import PRIMES, _root_of_unity
from mktfhe.ring.ntt import fwd_ntt, inv_ntt, make_plan


@pytest.mark.parametrize("n,npr", [(2048, 3), (1024, 2), (256, 1)])
def test_roundtrip(n, npr):
    mp = mx_plan(n, npr)
    rng = np.random.default_rng(0)
    ps = np.array(PRIMES[:npr], np.uint32)
    a = jnp.array(rng.integers(0, ps[None, :, None], (2, npr, n)).astype(np.uint32))
    assert jnp.all(mx_inv_ref(mx_fwd_ref(a, mp), mp) == a)


def test_convolution_matches_round1_pipeline():
    n, npr = 2048, 3
    mp = mx_plan(n, npr)
    plan = make_plan(n, npr)
    rng = np.random.default_rng(1)
    ps = np.array(PRIMES[:npr], np.uint32)
    pu = jnp.array(ps, jnp.uint64)[:, None]
    a = jnp.array(rng.integers(0, ps[None, :, None], (2, npr, n)).astype(np.uint32))
    b = jnp.array(rng.integers(0, ps[None, :, None], (2, npr, n)).astype(np.uint32))

    def conv(fwd, inv, pl_):
        ah, bh = fwd(a, pl_), fwd(b, pl_)
        prod = ((ah.astype(jnp.uint64) * bh.astype(jnp.uint64)) % pu).astype(jnp.uint32)
        return inv(prod, pl_)

    assert jnp.all(conv(mx_fwd_ref, mx_inv_ref, mp) == conv(fwd_ntt, inv_ntt, plan))


def test_is_true_ntt_small():
    """Brute-force negacyclic DFT at N=256: the mx transform computes the
    exact evaluations X[k] = sum_n x[n] psi^(n(2k+1)), position pos ->
    k = k1 + 128*bitrev(k2') for pos = k2'*128 + k1."""
    n, p = 256, PRIMES[0]
    mp = mx_plan(n, 1)
    psi = _root_of_unity(p, 2 * n)
    rng = np.random.default_rng(2)
    x = rng.integers(0, p, n).astype(object)
    want = np.array(
        [
            sum(int(x[i]) * pow(psi, (i * (2 * k + 1)) % (2 * n), p) for i in range(n)) % p
            for k in range(n)
        ],
        dtype=np.uint64,
    )
    got = np.asarray(mx_fwd_ref(jnp.array(np.asarray(x, np.uint32)[None, None]), mp))[0, 0]
    nb = n // NK
    for pos in range(n):
        k2p, k1 = divmod(pos, NK)
        k2 = int(f"{k2p:0{nb.bit_length()-1}b}"[::-1], 2) if nb > 1 else 0
        assert int(got[pos]) == int(want[k1 + NK * k2])


def test_mx_order_roundtrip():
    rng = np.random.default_rng(3)
    x = jnp.array(rng.integers(0, 1 << 30, (3, 2048)).astype(np.uint32))
    assert jnp.all(from_mx_order(to_mx_order(x, 16), 16) == x)
