"""Ring layer: exact torus/CRT arithmetic, negacyclic NTT, samplers.

JAX counterpart of /root/reference/src/ring/ (arithmetic.jl,
polynomial.jl, sampler.jl, fft.jl).  Polynomials are plain jnp arrays
([..., N] torus coefficients, or [..., nprimes, N] uint32 CRT residues in
the evaluation domain), so the container types of the reference
(NativePoly/TransNativePoly) dissolve into array shapes.
"""

from .modring import (
    PRIMES,
    addmod,
    modsum,
    mulhi_u32,
    negmod,
    nprimes_for_bits,
    reduce_u32,
    shoup,
    shoup_mul,
    submod,
)
from .ntt import NttPlan, fwd_ntt, inv_ntt, make_plan, pointwise_shoup, shoup_pair
from .sampler import (
    block_binary,
    gaussian_torus,
    uniform_binary,
    uniform_ternary,
    uniform_torus,
)
from .torus import (
    CrtPlan,
    bits_of,
    divbits,
    from_crt,
    from_crt_u32,
    from_crt_u64,
    lift,
    lift_signed_small,
    lift_u32,
    lift_u64,
    make_crt_plan,
    negacyclic_roll,
)

__all__ = [
    "PRIMES",
    "NttPlan",
    "CrtPlan",
    "addmod",
    "bits_of",
    "block_binary",
    "divbits",
    "from_crt",
    "from_crt_u32",
    "from_crt_u64",
    "fwd_ntt",
    "gaussian_torus",
    "inv_ntt",
    "lift",
    "lift_signed_small",
    "lift_u32",
    "lift_u64",
    "make_crt_plan",
    "make_plan",
    "modsum",
    "mulhi_u32",
    "negacyclic_roll",
    "negmod",
    "nprimes_for_bits",
    "pointwise_shoup",
    "reduce_u32",
    "shoup",
    "shoup_mul",
    "shoup_pair",
    "submod",
    "uniform_binary",
    "uniform_ternary",
    "uniform_torus",
]
