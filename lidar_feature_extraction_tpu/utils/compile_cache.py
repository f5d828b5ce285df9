"""JAX's persistent compilation cache for the repo's scripts.

A cache directory is part of the cache's key, so it never moves: it is
``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself),
and otherwise ``<checkout>/.jax_cache``, which ``.gitignore`` lists.
Only the command-line scripts enable it; the test suite does not (a
persistent cache has crashed XLA:CPU in the suite, see
tests/conftest.py).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The cache directory the scripts use; no side effects."""
    env = os.environ.get(ENV)
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on at ``compile_cache_dir()``."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
