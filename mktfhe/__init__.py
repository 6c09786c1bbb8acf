"""mktfhe: a multi-key TFHE framework in JAX.

A from-scratch JAX/XLA implementation with the capabilities of the
SNUCP/MKTFHE reference (multi-key TFHE over the torus, eprint 2022/1460):
CGGI single-key gate bootstrapping, the LMSS block-binary variant, CCS19
multi-key bootstrapping, and the KMS two-phase multi-key scheme (plus its
block-binary variant), with the same 16 parameter presets.

Design stance (vs. the Julia reference at /root/reference):
  * All polynomial arithmetic is exact, via negacyclic NTTs over 29.4-bit
    CRT primes in uint32 -- no Float64 FFT, no precision caveats.
  * Ciphertexts are batched pytrees of stacked arrays; the gate API is
    vmapped over a batch of gates (the main throughput lever).
  * Blind rotation is a lax.scan over key bits; multi-key phase 1 shards
    over a `party` mesh axis; key switching is an int8 matmul.

uint64 torus support (the KMS schemes) requires jax x64 mode, enabled at
import.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: blind-rotation scans are large programs and
# recompiling them per process dominates cold-start time.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache lives at a fixed
# path inside the checkout (the path is part of the cache key).
_ENV_CACHE = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
CACHE_DIR = _ENV_CACHE or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _ENV_CACHE:
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from . import ring  # noqa: E402

__version__ = "0.1.0"
