"""Persistent compile cache for the repository's scripts.

The library itself never sets a cache; scripts (``chip_smoke.py``,
``bench.py`` and ``benchmarks/*``) call :func:`use_compile_cache` first.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def use_compile_cache() -> str:
    """Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
    cache there and nothing else is set; otherwise the cache goes to the
    fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``).  Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
