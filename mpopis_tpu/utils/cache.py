"""Persistent XLA compilation cache.

The policy step at K=8192 and the contact tasks take seconds to minutes to
compile; with the cache on, every process after the first starts in
seconds for shapes it has already seen.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at a fixed `.jax_cache`
directory in the checkout (the path is part of the cache key, so it must
not move between runs). Entry points (the CLI, bench.py, __graft_entry__,
chip_smoke.py, the test suite) call `enable_compilation_cache()`; library
imports stay side-effect free.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX already uses it and nothing is
    changed. Otherwise the cache points at `DEFAULT_DIR`, and the
    min-compile-time and min-entry-size gates are dropped so that every
    compile of the program is kept.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return cache_dir()
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return DEFAULT_DIR
