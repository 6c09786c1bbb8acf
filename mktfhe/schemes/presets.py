"""The 16 concrete parameter presets.

Numerically identical to /root/reference/src/tfhe/params.jl:1-125 (public
scheme parameters from the companion papers: CGGI16, LMSS23, CCS19, and
eprint 2022/1460).  Noise stddevs are in absolute torus units: alpha = 2^17
on the 2^32 torus, beta = 2^7 (CGGI rings) or 85.4084 (KMS 2^64 rings).
"""

from __future__ import annotations

from .params import BlockParams, CcsParams, CggiParams, KmsBlockParams, KmsParams

CGGI_PARAM = CggiParams(
    n=630, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, k=1, beta=float(1 << 7), l_gsw=3, log_b_gsw=9,
)

BLOCK_PARAM = BlockParams(
    d=229, ell=3, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, k=1, beta=float(1 << 7), l_gsw=3, log_b_gsw=9,
)

CCS_2PARTY = CcsParams(
    n=560, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, beta=float(1 << 4), l_uni=3, log_b_uni=8, k=2,
)

CCS_4PARTY = CcsParams(
    n=560, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, beta=float(1 << 4), l_uni=4, log_b_uni=8, k=4,
)

CCS_8PARTY = CcsParams(
    n=560, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, beta=float(1 << 4), l_uni=5, log_b_uni=6, k=8,
)

CCS_16PARTY = CcsParams(
    n=560, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, beta=float(1 << 4), l_uni=12, log_b_uni=2, k=16,
)

# Noise-hardened CCS variants (this framework's own, not in the reference).
# The dominant CCS blind-rotation noise terms are the UniEnc d-noise
# amplified by the ring key and the public-key noise amplified by the
# ephemeral key r (see NOISE.md); both scale as l_uni * B_uni^2 * beta^2.
# At the reference's published k=2/4/8 gadgets (params.jl:15-45) the
# resulting margin is ~2.5 sigma -- inherent to the parameters, measured
# identical to the scheme-algebra prediction.  These variants keep every
# security-relevant parameter (n, N, alpha, beta, k) and refine only the
# gadget (more digits, smaller base), cutting the amplified noise 32-128x
# at ~2x the per-gate NTT cost.
CCS_2PARTY_TIGHT = CcsParams(
    n=560, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, beta=float(1 << 4), l_uni=6, log_b_uni=4, k=2,
)

CCS_4PARTY_TIGHT = CcsParams(
    n=560, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, beta=float(1 << 4), l_uni=8, log_b_uni=4, k=4,
)

CCS_8PARTY_TIGHT = CcsParams(
    n=560, alpha=float(1 << 17), f=8, log_d=2,
    big_n=1 << 10, beta=float(1 << 4), l_uni=10, log_b_uni=3, k=8,
)

_KMS_COMMON = dict(
    n=560, alpha=float(1 << 17), f=8, log_d=2, big_n=1 << 11, beta=85.4084,
)

KMS_2PARTY = KmsParams(
    **_KMS_COMMON, l_gsw=3, log_b_gsw=12, l_lev=2, log_b_lev=7,
    l_uni=3, log_b_uni=10, k=2,
)

KMS_4PARTY = KmsParams(
    **_KMS_COMMON, l_gsw=5, log_b_gsw=8, l_lev=2, log_b_lev=8,
    l_uni=7, log_b_uni=6, k=4,
)

KMS_8PARTY = KmsParams(
    **_KMS_COMMON, l_gsw=4, log_b_gsw=9, l_lev=3, log_b_lev=6,
    l_uni=8, log_b_uni=4, k=8,
)

KMS_16PARTY = KmsParams(
    **_KMS_COMMON, l_gsw=5, log_b_gsw=8, l_lev=3, log_b_lev=6,
    l_uni=9, log_b_uni=4, k=16,
)

KMS_32PARTY = KmsParams(
    **_KMS_COMMON, l_gsw=6, log_b_gsw=7, l_lev=3, log_b_lev=7,
    l_uni=16, log_b_uni=2, k=32,
)

_KMS_BLOCK_COMMON = dict(
    d=203, ell=3, alpha=float(1 << 17), f=8, log_d=2, big_n=1 << 11, beta=85.4084,
)

KMS_2PARTY_BLOCK = KmsBlockParams(
    **_KMS_BLOCK_COMMON, l_gsw=3, log_b_gsw=12, l_lev=2, log_b_lev=7,
    l_uni=3, log_b_uni=10, k=2,
)

KMS_4PARTY_BLOCK = KmsBlockParams(
    **_KMS_BLOCK_COMMON, l_gsw=5, log_b_gsw=8, l_lev=2, log_b_lev=8,
    l_uni=7, log_b_uni=6, k=4,
)

KMS_8PARTY_BLOCK = KmsBlockParams(
    **_KMS_BLOCK_COMMON, l_gsw=4, log_b_gsw=9, l_lev=3, log_b_lev=6,
    l_uni=8, log_b_uni=4, k=8,
)

KMS_16PARTY_BLOCK = KmsBlockParams(
    **_KMS_BLOCK_COMMON, l_gsw=5, log_b_gsw=8, l_lev=3, log_b_lev=6,
    l_uni=9, log_b_uni=4, k=16,
)

KMS_32PARTY_BLOCK = KmsBlockParams(
    **_KMS_BLOCK_COMMON, l_gsw=6, log_b_gsw=7, l_lev=3, log_b_lev=7,
    l_uni=16, log_b_uni=2, k=32,
)

# Reduced-dimension presets for demos/CI only -- NOT cryptographically
# secure parameters (the 16 sets above mirror the reference's).
TINY_CGGI = CggiParams(
    n=16, alpha=16.0, f=8, log_d=2, big_n=64, k=1, beta=16.0, l_gsw=3, log_b_gsw=8
)
TINY_KMS_2PARTY = KmsParams(
    n=8, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0,
    l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)
# N=128 variant of the above (golden vectors, tests/test_goldens.py).
TINY_KMS_2PARTY_N128 = KmsParams(
    n=8, alpha=16.0, f=8, log_d=2, big_n=128, beta=4.0,
    l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)

TEST_PRESETS = {
    "TinyCGGI": TINY_CGGI,
    "TinyKMS2party": TINY_KMS_2PARTY,
    "TinyKMS2partyN128": TINY_KMS_2PARTY_N128,
}

ALL_PRESETS = {
    "CGGI": CGGI_PARAM,
    "Block": BLOCK_PARAM,
    "CCS2party": CCS_2PARTY,
    "CCS4party": CCS_4PARTY,
    "CCS8party": CCS_8PARTY,
    "CCS16party": CCS_16PARTY,
    "CCS2partyTight": CCS_2PARTY_TIGHT,
    "CCS4partyTight": CCS_4PARTY_TIGHT,
    "CCS8partyTight": CCS_8PARTY_TIGHT,
    "KMS2party": KMS_2PARTY,
    "KMS4party": KMS_4PARTY,
    "KMS8party": KMS_8PARTY,
    "KMS16party": KMS_16PARTY,
    "KMS32party": KMS_32PARTY,
    "KMS2partyblock": KMS_2PARTY_BLOCK,
    "KMS4partyblock": KMS_4PARTY_BLOCK,
    "KMS8partyblock": KMS_8PARTY_BLOCK,
    "KMS16partyblock": KMS_16PARTY_BLOCK,
    "KMS32partyblock": KMS_32PARTY_BLOCK,
    **TEST_PRESETS,
}
