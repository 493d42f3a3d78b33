"""Persistent XLA compilation cache.

Every entry point (CLI, bench, tests, live session) reuses compiled
executables across processes. Where the cache lives:

- `JAX_COMPILATION_CACHE_DIR`, when set: JAX reads it itself, and this
  module sets no other directory;
- otherwise `.jax_cache/` at the root of the checkout (listed in
  .gitignore). The path is part of the cache key, so it stays fixed.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path | None:
    """The directory this module sets, or None when the environment names
    one (JAX_COMPILATION_CACHE_DIR)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> None:
    import jax

    if jax.default_backend() == "cpu":
        # XLA:CPU executables do not reload reliably across machine
        # features, and CPU compiles are fast anyway
        return
    path = cache_dir()
    if path is not None:
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
