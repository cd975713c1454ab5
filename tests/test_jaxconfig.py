"""Process-wide JAX configuration (stoat_tpu/jaxconfig.py).

Each case runs in a fresh interpreter: the compilation cache and the
platform are fixed when JAX first initialises, so they cannot be
re-checked inside the test process.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import stoat_tpu.jaxconfig, jax; "
          "print(jax.config.jax_compilation_cache_dir); "
          "print(jax.devices()[0].platform)")


def _run(tmp_path, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    env.update(env_over)
    return subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_cache_dir_follows_environment(tmp_path):
    cache = str(tmp_path / "xla_cache")
    res = _run(tmp_path, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=cache)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == [cache, "cpu"]


def test_cache_dir_defaults_to_checkout(tmp_path):
    res = _run(tmp_path, JAX_PLATFORMS="cpu")
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == [os.path.join(REPO, ".jax_cache"),
                                       "cpu"]


def test_missing_platform_raises(tmp_path):
    """A named platform that cannot start fails the process; it never
    falls back to the CPU."""
    res = _run(tmp_path, JAX_PLATFORMS="cuda")
    assert res.returncode != 0
    assert "cpu" not in res.stdout.splitlines()
