"""JAX's persistent compilation cache, kept in one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
and nothing else is set.  Otherwise the cache lives at ``.jax_cache`` in
the root of the checkout (listed in ``.gitignore``).  The path is part of
the cache key, so it is fixed: never a temporary, per-process or dated
directory.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache(min_compile_time_secs: float | None = None) -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``; returns it.

    ``min_compile_time_secs`` sets the shortest compile worth caching.
    """
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    if min_compile_time_secs is not None:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          float(min_compile_time_secs))
    return path
