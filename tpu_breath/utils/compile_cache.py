"""Where JAX keeps compiled programs between processes.

A cold full-width run spends minutes compiling the feature graph and the
train steps; the persistent cache lets the next process load them instead.
If JAX_COMPILATION_CACHE_DIR is set, JAX reads it on its own and nothing is
set here. Otherwise the cache lives at the fixed path <checkout>/.cache/jax:
the directory is part of the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_dir() -> str:
    return os.path.join(CHECKOUT, ".cache", "jax")


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    path = default_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
