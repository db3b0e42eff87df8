"""Persistent XLA compile cache at a fixed place.

JAX keys its persistent cache on the directory among other things, so a
cache only pays when every run of a checkout uses the same one.
"""

from __future__ import annotations

import os

import jax

#: default cache directory: inside the checkout, listed in .gitignore
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at a fixed directory and
    return it.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads
    it itself and nothing else is configured.  Otherwise an accelerator
    run caches in ``<checkout>/.jax_cache``; a CPU run (the test suite)
    configures no cache and returns None."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
