"""The persistent XLA compile cache, configured in one place.

Every entry point (tests, bench.py, chip_smoke.py, __graft_entry__.py,
apps/ and tools/) calls :func:`enable_compile_cache` before its first
compile.
"""
from __future__ import annotations

import os

#: ``<checkout>/.jax_cache``: a fixed path, because the cache directory is
#: part of what a later process must find again.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Keep compiled programs on disk across processes; returns the
    directory in use.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    reads it itself and this sets nothing."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
