"""Placement of JAX's persistent compilation cache.

Compiled device programs are kept across processes so that a second run
of the same checkout skips XLA compilation. ``JAX_COMPILATION_CACHE_DIR``
wins when it is set (JAX reads it itself); otherwise the cache lives at a
fixed directory inside the checkout. The path is part of the cache key, so
it is never derived from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os
import sys

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax = sys.modules.get("jax")
    if jax is None:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = DEFAULT_DIR
    else:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
