"""Persistent XLA compilation cache for the production entry points.

The reference pays no compile cost (C++ AOT); here the first dispatch of
each (scene shape, pass shape) pair compiles.  Wiring the persistent cache
into the session/CLI means the SECOND run of the same .dae skips most of
that.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (nothing
here overrides it), else `<checkout>/.jax_cache` — a fixed path, because
the path is part of the cache's key, listed in .gitignore.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def cache_dir() -> str:
    """The directory the persistent cache uses (see module docstring)."""
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or DEFAULT_DIR


def enable() -> str:
    """Idempotently turn on the persistent compilation cache at
    cache_dir().  Safe to call before or after jax initialization."""
    import jax
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
    # cache every compile that took noticeable time (the default 1 s
    # floor skips mid-size graphs that still cost seconds)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.2)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    return path
