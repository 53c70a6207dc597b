"""Device/runtime initialization: the persistent XLA compilation cache.

The alignment and phasing kernels compile once per bucketed shape; the
persistent cache lets a later process load those executables instead of
compiling again.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that
directory and nothing here overrides it; otherwise the cache lives at a
fixed directory inside the checkout (``.jax_cache/``, git-ignored).  The
prewarm shape journal (utils/prewarm.py) lives in the same directory.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")

_initialized = False


def cache_dir() -> str:
    """The compile-cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def init_device() -> None:
    global _initialized
    if _initialized:
        return
    _initialized = True
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
