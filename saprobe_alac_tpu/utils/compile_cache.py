"""One place that decides where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os
from pathlib import Path

#: The in-checkout cache directory (listed in .gitignore).  A fixed path,
#: because the path is part of the cache key: a moving directory never hits.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".bench_cache" / "xla"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and is left alone (JAX
    reads it itself); otherwise the cache lives in ``.bench_cache/xla`` of
    this checkout.  Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
