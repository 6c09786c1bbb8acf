"""Noise-budget validation on the tiny test parameter sets."""

import jax
import jax.numpy as jnp
import numpy as np

from mktfhe.schemes import cggi
from mktfhe.schemes.gates import gate_affine, lwe_encrypt_bit
from mktfhe.utils.noise import noise_report

from test_cggi import TINY


def test_cggi_tiny_noise_margin():
    lwe_key, _rk, scheme = cggi.setup(jax.random.key(7), TINY)
    g = 32
    rng = np.random.default_rng(2)
    m1 = rng.integers(0, 2, g).astype(bool)
    m2 = rng.integers(0, 2, g).astype(bool)
    ct1 = lwe_encrypt_bit(jax.random.key(1), jnp.array(m1), lwe_key, TINY.alpha, (g,))
    ct2 = lwe_encrypt_bit(jax.random.key(2), jnp.array(m2), lwe_key, TINY.alpha, (g,))
    out = cggi.bootstrap(gate_affine(0, ct1, ct2), scheme, TINY)
    rep = noise_report(out, [lwe_key], ~(m1 & m2))
    # tiny params: modulus-switch noise dominates; still want >= 4 sigma
    assert rep["margin_sigmas"] > 4, rep
    assert rep["max_abs_bits"] < rep["margin_bits"], rep
