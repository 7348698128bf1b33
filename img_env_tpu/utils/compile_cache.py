"""Where JAX keeps its persistent compilation cache.

The cache is keyed on the directory too, so it has to be one fixed path:
``JAX_COMPILATION_CACHE_DIR`` when the caller sets it (JAX reads the
variable itself, and nothing else is set here), otherwise ``.jax_cache/`` at
the root of this checkout (listed in .gitignore).  Every entry point (bench,
chip smoke run, tests, the graft entry) calls ``enable_compile_cache`` before
it compiles.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    import jax

    os.makedirs(CHECKOUT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    # small programs recompile faster than a cache round trip
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CHECKOUT_CACHE
