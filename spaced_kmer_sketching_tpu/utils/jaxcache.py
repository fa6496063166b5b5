"""Persistent XLA compilation cache.

A cold compile of the sketch and all-pairs programs takes seconds to
minutes; the persistent cache makes reruns (sweeps, CLI restarts, bench)
start hot.  Called by the entry points (driver CLI, bench, chip_smoke,
graft entry) — not on library import, to avoid config side effects for
embedders.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no other directory.  Otherwise the cache lives at a fixed path inside
the checkout, `<repo>/.jax_cache` (git-ignored): the path is part of the
cache key, so it must not move between runs."""
from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
