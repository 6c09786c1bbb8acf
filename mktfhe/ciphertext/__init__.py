"""Ciphertext algebra: keys, LWE/RLWE/RLEV/RGSW/UniEnc, gadget decomposition.

JAX counterpart of /root/reference/src/ciphertext/.  All ciphertexts
are batched pytrees of stacked arrays; evaluation-domain images are CRT
residue arrays produced by the exact NTT.
"""

from .decomp import balanced_decomp, unbalanced_decomp
from .gsw import (
    external_product_hat,
    rgsw_add,
    rgsw_encrypt,
    rgsw_sub,
    rgsw_to_hat,
    rlwe_decomp_hat,
)
from .lev import (
    Gsw,
    Lev,
    gsw_add,
    gsw_encrypt,
    gsw_sub,
    lev_add,
    lev_encrypt,
    lev_ith_encrypt,
    lev_sub,
)
from .keys import (
    LweKey,
    RingKey,
    binary_lwe_key,
    binary_ring_key,
    block_binary_lwe_key,
    partial_ring_key,
    ternary_lwe_key,
    ternary_ring_key,
)
from .lwe import (
    Lwe,
    lwe_add,
    lwe_encrypt,
    lwe_ith_encrypt,
    lwe_neg,
    lwe_sample,
    lwe_sub,
    phase,
)
from .rlwe import (
    gadget_gvec,
    rlev_encrypt,
    rlwe_encrypt_msg,
    rlwe_phase,
    rlwe_sample,
)
from .unienc import UniEnc, gen_b, sample_crs, unienc_encrypt

__all__ = [
    "Gsw",
    "Lev",
    "Lwe",
    "LweKey",
    "RingKey",
    "UniEnc",
    "gsw_add",
    "gsw_encrypt",
    "gsw_sub",
    "lev_add",
    "lev_encrypt",
    "lev_ith_encrypt",
    "lev_sub",
    "rgsw_add",
    "rgsw_sub",
    "balanced_decomp",
    "binary_lwe_key",
    "binary_ring_key",
    "block_binary_lwe_key",
    "external_product_hat",
    "gadget_gvec",
    "gen_b",
    "lwe_add",
    "lwe_encrypt",
    "lwe_ith_encrypt",
    "lwe_neg",
    "lwe_sample",
    "lwe_sub",
    "partial_ring_key",
    "phase",
    "rgsw_encrypt",
    "rgsw_to_hat",
    "rlev_encrypt",
    "rlwe_decomp_hat",
    "rlwe_encrypt_msg",
    "rlwe_phase",
    "rlwe_sample",
    "sample_crs",
    "ternary_lwe_key",
    "ternary_ring_key",
    "unbalanced_decomp",
    "unienc_encrypt",
]
