"""Profiling helpers: wall-clock + jax.profiler traces.

The reference has no tracing/profiling subsystem (its compute pass even
passes ``timestamp_writes: None``, src/engine.rs:484); this thin layer is
the observability tier (SURVEY.md §5): device timing via wall clock
around ``block_until_ready``, and optional XLA/GPU traces viewable in
Perfetto/TensorBoard via ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, Optional


__all__ = ["timed", "trace", "measure_throughput"]


@contextlib.contextmanager
def timed(label: str = "block") -> Iterator[dict]:
    """Wall-clock a block; the dict gains 'seconds' on exit.

    >>> with timed("integrate") as t:
    ...     integrator.integrate(...)
    >>> t["seconds"]
    """
    rec = {"label": label}
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace into ``log_dir`` (open with
    TensorBoard's profile plugin or Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def measure_throughput(
    fn: Callable[[int], object],
    work_per_call: int,
    repeats: int = 5,
    warmup: int = 1,
) -> float:
    """Sustained work-units/sec of ``fn(rep)``.

    ``fn`` must return device arrays (or a pytree of them); every timed
    call is blocked on before the clock stops.
    """
    import jax

    for i in range(warmup):
        jax.block_until_ready(fn(i))
    t0 = time.perf_counter()
    outs = [fn(warmup + rep) for rep in range(repeats)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    return work_per_call * repeats / dt
