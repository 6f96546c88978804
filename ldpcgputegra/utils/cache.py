"""Persistent XLA compilation cache.

The decoders unroll every layer of a code, so the 64800-bit views compile
to large programs; a persistent cache lets every process after the first
skip that.  Called by the entry points (bench, CLI, smoke run) — not on
package import, to stay side-effect free for library users.

Where the cache lives: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and nothing else is configured here); otherwise one fixed
directory inside the checkout, ``<repo>/.jax_cache``, because the path is
part of what a later process must find again.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent cache; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_CACHE_DIR
