"""One place that decides where JAX keeps its persistent compile cache.

Every entry point (``run.py``, ``multirun.py``, ``bench.py`` and
``chip_smoke.py``) calls :func:`configure_compile_cache` before its
first compile, so all of them share one cache directory:

* where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
  this function sets nothing else;
* otherwise the cache lives at ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``). The path is part of the cache key, so it is fixed
  to the checkout rather than to the working directory.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def configure_compile_cache() -> str:
    """Enable the persistent compile cache; return the directory in use."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
