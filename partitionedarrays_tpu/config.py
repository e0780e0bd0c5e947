"""Process-wide configuration.

The reference passes Val{}-typed static flags per call
(src/p_sparse_matrix.jl:1094-1161); here the equivalents are static Python
values read while tracing, so they specialize the compiled program.  The
only process-wide setting left is JAX's persistent compilation cache.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

# <checkout>/.jax_cache: a fixed path, so the cache key (which includes the
# directory) is the same in every run from this checkout
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir() -> str:
    """Directory of the persistent compilation cache:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``DEFAULT_CACHE_DIR``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> Optional[str]:
    """Enable JAX's persistent compilation cache and return its directory.

    Setup compiles a handful of per-shape programs (stencil generators, GS
    state builds, solver bodies); caching them on disk turns repeat setups
    from compile-bound into load-bound.  Called lazily at backend
    construction (not at package import, which would initialize the
    backend before a user's ``jax.distributed.initialize``).

    Skipped on CPU (returns None): cached XLA:CPU executables are specific
    to the host's CPU features and reload with mismatch warnings on
    heterogeneous hosts.  Errors are raised, not swallowed."""
    if jax.devices()[0].platform == "cpu":
        return None
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # small per-shape setup programs are exactly what repeat runs reuse
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
