"""Persistent XLA compilation cache setup.

A cold engine compiles its fused step for every batch shape; the
persistent cache turns a later process's compiles into loads.  The
cache is keyed by the lowered program, so it is safe across processes.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and nothing here overrides it); otherwise the fixed
directory ``.jax_cache/`` at the root of the checkout (listed in
``.gitignore``).  A fixed path is part of the point: a directory that
moves between runs never hits.  ``BARBELL_JAX_CACHE=0`` disables it.
"""

from __future__ import annotations

import os

_DONE = False

#: the in-checkout default cache directory
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    if os.environ.get("BARBELL_JAX_CACHE", "1") in ("", "0"):
        return
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX already reads it; set nothing else
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    # The cache key hashes the lowered module INCLUDING the MLIR
    # location tracebacks, which embed the CALLER's file:line — so any
    # new entry script (or an edit shifting line numbers in the call
    # chain) would miss a warm cache.  Dropping tracebacks from
    # locations makes the key depend only on the computation.  Set
    # BARBELL_JAX_DEBUG_LOCS=1 to keep full locations when debugging
    # compiler errors.
    if os.environ.get("BARBELL_JAX_DEBUG_LOCS", "") in ("", "0"):
        jax.config.update("jax_include_full_tracebacks_in_locations", False)
