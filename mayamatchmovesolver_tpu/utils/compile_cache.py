"""Where JAX keeps its persistent compilation cache.

The solver's long `while_loop` programs (Schur BA with CG, dense LM)
take tens of seconds to compile, so entry points (the CLI, the bench,
`chip_smoke.py`) keep compiled executables between runs.  Library
callers are left to choose for themselves: importing the package sets
nothing.
"""

import os

import jax

CACHE_DIR_ENV = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.jax_cache: a fixed path, because the directory is part of
# what a later run must find again (listed in .gitignore).
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache():
    """Turn on the persistent compilation cache for an entry point.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to CHECKOUT_CACHE_DIR.
    Returns the directory set in code, or None."""
    if os.environ.get(CACHE_DIR_ENV):
        return None
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
