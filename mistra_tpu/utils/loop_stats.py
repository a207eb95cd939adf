"""Trip counts of the model's data-dependent while loops (diagnostics).

On the GPU each trip of a ``lax.while_loop`` returns its predicate to the
host, so the number of trips per minute step is a cost in itself.  Inside
``counting()``, programs traced by ``jax.jit`` report every while loop's
trip count through ``jax.debug.callback``; outside it ``record`` adds
nothing to the traced program.  Usage::

    with loop_stats.counting() as counts:
        out = jax.jit(step)(state)          # traced inside the context
        jax.block_until_ready(out)
        jax.effects_barrier()
    counts["kon_newton"]                    # list of trip-count arrays
"""

from __future__ import annotations

import collections
import contextlib

import jax
import numpy as np

_COUNTS = None


@contextlib.contextmanager
def counting():
    """Collect trip counts of loops traced inside this context."""
    global _COUNTS
    prev, _COUNTS = _COUNTS, collections.defaultdict(list)
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def record(name: str, count) -> None:
    """Report one loop's trip count (a traced integer) under ``name``."""
    if _COUNTS is None:
        return
    sink = _COUNTS[name]
    jax.debug.callback(lambda c: sink.append(np.asarray(c)), count)
