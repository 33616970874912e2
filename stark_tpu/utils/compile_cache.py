"""JAX's persistent compilation cache, in one place.

Every entry point (CLI, benchmark, chip smoke test, tests) calls
:func:`enable` before its first compile. The directory is
`JAX_COMPILATION_CACHE_DIR` when that is set (JAX reads the variable
itself, so nothing here overrides it), otherwise the fixed path
`<checkout>/.jax_cache`. The path is part of the cache's key, so it is
never derived from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    return os.environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX at the cache directory; returns it."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
