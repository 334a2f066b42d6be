"""Persistent XLA compile cache location.

Entry points (the CLI, chip_smoke.py, bench.py, the examples) call
``enable_compile_cache()`` once at start-up; importing the package sets
nothing. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module leaves it alone. Otherwise the cache goes to one fixed
directory inside the checkout: the cache directory is part of the
cache's key, so a path built from a temp name, a pid or the time would
never be hit again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV_VAR) or CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``;
    returns that directory."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
