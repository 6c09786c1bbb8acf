"""Scheme layer: parameters, presets, keygen, bootstrapping, gates.

JAX counterpart of /root/reference/src/tfhe/.
"""

from . import cggi
from .gates import (
    CLEAR_OPS,
    GATE_IDS,
    GATE_TABLE,
    gate,
    gate_affine,
    lwe_decrypt_bit,
    lwe_decrypt_bit_mk,
    lwe_encrypt_bit,
    lwe_ith_encrypt_bit,
    not_gate,
)
from .params import BlockParams, CcsParams, CggiParams, KmsBlockParams, KmsParams
from .presets import ALL_PRESETS

__all__ = [
    "ALL_PRESETS",
    "BlockParams",
    "CLEAR_OPS",
    "CcsParams",
    "CggiParams",
    "GATE_IDS",
    "GATE_TABLE",
    "KmsBlockParams",
    "KmsParams",
    "cggi",
    "gate",
    "gate_affine",
    "lwe_decrypt_bit",
    "lwe_decrypt_bit_mk",
    "lwe_encrypt_bit",
    "lwe_ith_encrypt_bit",
    "not_gate",
]
