"""Tracing/profiling hooks (SURVEY.md §5 "Tracing / profiling").

Thin wrappers over jax.profiler so benchmark loops produce TensorBoard/
Perfetto traces, plus named scopes so each multigrid level shows up as its
own row in the trace viewer.
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace around a block:

    >>> with trace("/tmp/mg-trace"):
    ...     solver.solve().x.block_until_ready()
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def level_scope(level: int):
    """Named scope for one multigrid level (visible in traces)."""
    return jax.named_scope(f"mg_level_{level}")


class Timer:
    """Wall-clock timer; fence the work inside it with ``Timer.fence``.

    JAX returns before the device finishes, so a timing without a fence
    measures only the enqueue.
    """

    def __init__(self):
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @staticmethod
    def fence(x):
        """Block until ``x`` (any pytree of arrays) is computed."""
        return jax.block_until_ready(x)
