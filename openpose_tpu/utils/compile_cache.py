"""Persistent XLA compilation cache.

Cold compiles of the cuDNN-autotuned BODY_25 programs are a large part of a
cold run; JAX's persistent compilation cache lets every later process (bench
runs, CLI invocations, scripts) reuse the serialized executables.  The cache
keys on its directory, so the directory never moves:
``JAX_COMPILATION_CACHE_DIR`` as given when set, else a fixed directory
inside the checkout.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str:
    """Turn on the JAX persistent compilation cache; returns its directory.

    Safe to call multiple times and after backend initialization (the cache
    config is not backend-pinned)."""
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(CHECKOUT_CACHE_DIR))
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
