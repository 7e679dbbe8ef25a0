"""JAX's persistent compilation cache at a fixed place.

A cold run compiles the unrolled Riccati interior point and the 120-iteration
ADMM scan from scratch; the persistent cache keeps those executables across
processes.  The cache key includes the directory, so the directory must not
move between runs: it is never built from a temporary name, a PID or the time.
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing is set here.  Otherwise the cache goes to
    ``<repo>/.jax_cache``.  Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
