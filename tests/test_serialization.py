"""Key checkpoint tests: save/load round trip preserving bootstrap output."""

import jax
import jax.numpy as jnp
import numpy as np

from mktfhe.schemes import cggi
from mktfhe.schemes.cggi import CggiScheme
from mktfhe.schemes.gates import gate_affine, lwe_encrypt_bit
from mktfhe.utils import load, save

from test_cggi import TINY


def test_scheme_roundtrip(tmp_path):
    lwe_key, _rk, scheme = cggi.setup(jax.random.key(3), TINY)
    path = str(tmp_path / "scheme.npz")
    save(path, scheme)
    back = load(path)
    assert isinstance(back, CggiScheme)
    for name in scheme.__dataclass_fields__:
        np.testing.assert_array_equal(
            np.asarray(getattr(scheme, name)), np.asarray(getattr(back, name))
        )

    m = jnp.array([True, False])
    ct1 = lwe_encrypt_bit(jax.random.key(1), m, lwe_key, TINY.alpha, (2,))
    ct2 = lwe_encrypt_bit(jax.random.key(2), ~m, lwe_key, TINY.alpha, (2,))
    ct = gate_affine(0, ct1, ct2)
    a = cggi.bootstrap(ct, scheme, TINY)
    b = cggi.bootstrap(ct, back, TINY)
    np.testing.assert_array_equal(np.asarray(a.b), np.asarray(b.b))
    np.testing.assert_array_equal(np.asarray(a.a), np.asarray(b.a))
