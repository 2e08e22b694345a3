"""Where JAX's persistent compilation cache lives.

The sampler's scans take long to compile, so every entry point that
compiles them (``chip_smoke.py``, ``bench.py``, the example drivers, the
test suite) keeps compiled programs across processes. The path is part of
the cache's key, so it is fixed: ``JAX_COMPILATION_CACHE_DIR`` when the
environment sets it (JAX reads that variable itself, and no other cache is
set in code), otherwise ``.jax_cache/`` at the checkout root.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> pathlib.Path:
    """The directory the compilation cache is written to."""
    env = os.environ.get(ENV_VAR)
    return pathlib.Path(env) if env else CHECKOUT_CACHE


def enable_compile_cache() -> pathlib.Path:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Call before the first compilation. Returns the directory in use.
    """
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
