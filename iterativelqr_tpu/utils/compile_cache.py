"""Persistent XLA compile cache setup.

The solve is one large while-loop program whose compilation dominates cold
starts, so every entry point (bench.py, chip_smoke.py, the benchmarks, the
tests) keeps JAX's persistent compile cache.  Where it lives is a deployment
setting: ``JAX_COMPILATION_CACHE_DIR`` is used as is when it is set;
otherwise the cache goes to a fixed directory inside the checkout (listed in
``.gitignore``), so that repeated runs from one checkout find it again.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory (see the module
    docstring) before the first compilation.  Returns the directory used."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
