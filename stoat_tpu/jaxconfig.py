"""Process-wide JAX configuration for stoat-tpu.

Importing this module (which every stats/pipeline module does first) enables
x64 mode: the association statistics must match a C++ double-precision oracle
to 4 significant digits, including extreme tails (p ~ 1e-300), which float32
cannot represent.  The genotype-membership contractions stay float32 (their
operands are small integers, exact in f32) — only the per-snarl statistics
run in f64.

Persistent compilation cache: when ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and nothing is configured here.  Otherwise executables
are cached in ``<checkout>/.jax_cache`` — a fixed path, so the same program
hits the cache from run to run.

No backend fallback: a platform named in ``JAX_PLATFORMS`` that fails to
start fails the process at the first device query.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
