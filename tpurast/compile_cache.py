"""Persistent XLA compile cache location.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here overrides it. Otherwise the entry points (tpurast.cli.main,
chip_smoke.py, Engine) point JAX at a fixed directory beside the
package, `<repo>/.jax_cache`: the path is part of the cache key, so a
fixed one lets a later process on the same checkout reuse compiled frame
functions instead of recompiling them.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable() -> str:
    """Point JAX's persistent compile cache at cache_dir(); returns it.

    Call before the first compilation of the process."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
