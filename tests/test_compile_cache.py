"""Where the persistent compilation cache goes: JAX_COMPILATION_CACHE_DIR
when it is set (and nothing else is set in code), else <checkout>/.jax_cache."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = (
    "import jax, mktfhe; "
    "print(mktfhe.CACHE_DIR); print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    return r.stdout.split()


def test_cache_in_checkout_by_default():
    assert _probe(None) == [os.path.join(ROOT, ".jax_cache")] * 2


def test_cache_follows_env(tmp_path):
    assert _probe(str(tmp_path)) == [str(tmp_path)] * 2
