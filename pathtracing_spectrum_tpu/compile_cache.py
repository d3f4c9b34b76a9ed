"""Persistent XLA compile cache for the program's entry points.

``enable_compile_cache()`` is called by ``cli.main``, ``chip_smoke.py``,
``bench.py`` and ``bench_suite.py`` — never on import, so library users
and the tests keep JAX's own default. If ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it and nothing is set here; otherwise the cache lives in a
fixed directory of the checkout, ``<repo>/.jax_cache`` (gitignored).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
