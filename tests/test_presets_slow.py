"""Preset-parameter smoke tests (slow; full dimensions on CPU).

Run explicitly with: pytest tests/test_presets_slow.py -m slow
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from mktfhe.schemes import ccs, cggi, kms, lmss
from mktfhe.schemes.gates import (
    gate_affine,
    lwe_decrypt_bit,
    lwe_decrypt_bit_mk,
    lwe_encrypt_bit,
    lwe_ith_encrypt_bit,
)
from mktfhe.schemes.presets import ALL_PRESETS, BLOCK_PARAM, CGGI_PARAM
from mktfhe.utils.noise import noise_report


@pytest.mark.parametrize(
    "mod,params", [(cggi, CGGI_PARAM), (lmss, BLOCK_PARAM)], ids=["CGGI", "Block"]
)
def test_preset_gate(mod, params):
    lwe_key, _rk, scheme = mod.setup(jax.random.key(0), params)
    g = 8
    rng = np.random.default_rng(0)
    m1 = rng.integers(0, 2, g).astype(bool)
    m2 = rng.integers(0, 2, g).astype(bool)
    ct1 = lwe_encrypt_bit(jax.random.key(1), jnp.array(m1), lwe_key, params.alpha, (g,))
    ct2 = lwe_encrypt_bit(jax.random.key(2), jnp.array(m2), lwe_key, params.alpha, (g,))
    out = mod.bootstrap(gate_affine(0, ct1, ct2), scheme, params)
    got = np.asarray(lwe_decrypt_bit(out, lwe_key))
    np.testing.assert_array_equal(got, ~(m1 & m2))
    rep = noise_report(out, [lwe_key], ~(m1 & m2))
    assert rep["margin_sigmas"] > 6, rep


# Every multi-key preset at full dimensions (reference semantics:
# /root/reference/test/KMS.jl:5-37, test/CCS.jl).  Very slow on CPU at
# high k; scripts/preset_margins.py runs the same trial per preset on the
# real chip and commits the margin table (MARGINS.md).
MK_PRESETS = [n for n in ALL_PRESETS if n.startswith(("CCS", "KMS"))]


@pytest.mark.parametrize("name", MK_PRESETS)
def test_mk_preset_gate(name):
    params = ALL_PRESETS[name]
    mod = ccs if name.startswith("CCS") else kms
    k = params.k
    a = mod.crs(jax.random.key(0), params)
    parties = [mod.party_keygen(jax.random.key(1 + i), a, params) for i in range(k)]
    keys = [p[0] for p in parties]
    scheme = mod.setup(a, [p[2 if mod is ccs else 3] for p in parties], params)
    g = 4
    rng = np.random.default_rng(0)
    m1 = rng.integers(0, 2, g).astype(bool)
    m2 = rng.integers(0, 2, g).astype(bool)
    ct1 = lwe_ith_encrypt_bit(jax.random.key(11), jnp.array(m1), 0, keys[0], params.alpha, k, (g,))
    ct2 = lwe_ith_encrypt_bit(jax.random.key(12), jnp.array(m2), 1, keys[1], params.alpha, k, (g,))
    out = mod.bootstrap(gate_affine(0, ct1, ct2), scheme, params)
    got = np.asarray(lwe_decrypt_bit_mk(out, keys))
    np.testing.assert_array_equal(got, ~(m1 & m2))
    rep = noise_report(out, keys, ~(m1 & m2))
    assert rep["margin_sigmas"] > 6, rep
