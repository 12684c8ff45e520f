"""Persistent XLA compilation cache setup.

A cold solve compiles for seconds to minutes; the persistent cache makes a
repeat run reuse the compiled programs. Every entry point (bench, example
CLIs, tests, driver hooks, chip_smoke.py) calls `enable_compile_cache()`
first.

Where the cache lives: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it itself and this module sets no directory. Otherwise the cache goes to
the fixed ``<checkout>/.jax_cache`` (a fixed path, because the path is
part of the cache key).
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
