"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Keep compiled programs across processes; returns the cache dir.

    A ``JAX_COMPILATION_CACHE_DIR`` set in the environment is left alone
    (JAX reads it itself); otherwise the cache lives in ``.jax_cache`` at
    the root of the checkout, a fixed path, so later runs find it."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
