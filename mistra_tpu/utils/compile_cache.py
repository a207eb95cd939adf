"""Where the persistent XLA compilation cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache goes to one fixed directory inside the
checkout (``build/jax_cache``), so repeated runs of the CLI, the
benchmarks and the tests find what earlier runs compiled.
"""

from __future__ import annotations

import os

from ..paths import BUILD_DIR

DEFAULT_DIR = os.path.join(BUILD_DIR, "jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (call
    before the first compilation); returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
