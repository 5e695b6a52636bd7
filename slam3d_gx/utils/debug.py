"""Runtime numeric checking for jitted kernels.

The reference has no sanitizers (SURVEY.md §5.2 — single-threaded C++,
no -fsanitize anywhere); the JAX counterpart of its implicit "trust the
math" stance is jax.experimental.checkify: wrap any jitted pipeline
function to surface NaN/Inf and out-of-bounds indexing as Python
errors instead of silent garbage propagating into the pose graph.

Usage:
    from slam3d_gx.utils import debug
    extract_checked = debug.checked(extract)     # same signature
    out, err = extract_checked(*args)            # err.throw() on demand
    # or strict mode: raises immediately
    extract_strict = debug.strict(extract)
"""

from __future__ import annotations

from typing import Callable

import jax
from jax.experimental import checkify

CHECKS = checkify.float_checks | checkify.index_checks


def checked(fn: Callable) -> Callable:
    """Returns fn' with signature fn'(*a, **k) -> (error, out)."""
    return jax.jit(checkify.checkify(fn, errors=CHECKS))


def strict(fn: Callable) -> Callable:
    """Returns fn' that raises checkify errors eagerly (debug runs)."""
    inner = checked(fn)

    def run(*args, **kwargs):
        err, out = inner(*args, **kwargs)
        err.throw()
        return out

    return run
