"""Persistent compilation cache location — the one place the program sets it.

A full solve takes minutes to compile cold. Scripts that run the solver
(chip_smoke.py, bench.py, tools/*) call `enable_compile_cache()` first:
JAX keeps compiled programs in `JAX_COMPILATION_CACHE_DIR` when that is
set, and otherwise in `.jax_cache/` at the root of the checkout (listed in
.gitignore). The path is part of the cache key, so it stays fixed.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` if set, else the checkout's `.jax_cache/`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and cache every program that takes over a second to compile. Returns
    the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
