"""JAX environment setup for the device path.

The interchange contract widens everything to 8 bytes (``column_buffer.rs:17-21``)
and BASELINE requires bit-identical int64 keys, so the device path runs with x64
enabled (exactness over raw speed for keys; zone-map statistics narrow keys to
int32 where the range provably fits).

Persistent compilation cache: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing here overrides it.  Otherwise compiled programs
are cached at a fixed path inside the checkout (``<repo>/.jax_cache``, listed
in ``.gitignore``), so repeated runs from one checkout skip recompiles.
"""

from __future__ import annotations

import os

_READY = False

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compile_cache_dir() -> str:
    """The persistent compilation cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def ensure_jax():
    global _READY
    import jax

    if not _READY:
        jax.config.update("jax_enable_x64", True)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _READY = True
    return jax
