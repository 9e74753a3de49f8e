"""Workload planning: the JAX analog of the reference dispatch planner.

The reference partitions N samples over ~65,536 GPU threads with
``loops_per_thread = ceil(N / total_threads)`` (src/engine.rs:157-181); every
thread contributes equally, so the *actual* processed sample count is the
rounded-up ``total_threads * loops_per_thread >= N``.

For the XLA sweep the same partitioning becomes a scan over ``n_chunks``
blocks of ``chunk_elems`` samples.  We preserve the equal-weight,
rounded-up-count semantics — ``actual_samples >= n_samples`` and the mean
divides by ``actual_samples``.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["IntegratePlan", "make_integrate_plan", "round_up", "DEFAULT_TARGET_THREADS"]

# Reference defaults: target 65,536 threads, workgroup 256 (engine.rs:164-165).
DEFAULT_TARGET_THREADS = 65_536
_LANE_MULTIPLE = 256
# Max elements per scan block.  On the GPU larger blocks amortise the
# scan's per-step cost: 1 << 26 measured fastest of 1 << 22 / 24 / 26 on
# an H100 at the K=8 headline, for a peak of ~270 MB of device memory
# (PERF.md); the CPU test backend keeps blocks small.
DEFAULT_MAX_CHUNK_ELEMS = 1 << 22
GPU_MAX_CHUNK_ELEMS = 1 << 26


def default_max_chunk_elems() -> int:
    import jax

    gpu = jax.default_backend() == "gpu"
    return GPU_MAX_CHUNK_ELEMS if gpu else DEFAULT_MAX_CHUNK_ELEMS


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class IntegratePlan:
    """Static integration workload description (part of the jit cache key)."""

    total_threads: int  # lane width of one scan step
    loops_per_chunk: int  # sample rows per scan step
    n_chunks: int  # scan length
    actual_samples: int  # total_threads * loops_per_chunk * n_chunks >= n

    @property
    def chunk_elems(self) -> int:
        return self.total_threads * self.loops_per_chunk


def make_integrate_plan(
    n_samples: int,
    target_threads: int | None = None,
    max_chunk_elems: int | None = None,
    n_dev: int = 1,
) -> IntegratePlan:
    """Plan the chunked sample sweep.

    ``target_threads`` survives from the reference API as the lane-width
    knob (rounded up to a multiple of 256, engine.rs:165); the planner then
    groups as many loops per scan step as fit in ``max_chunk_elems``.  With
    ``n_dev`` devices the chunk count is shaped to divide evenly across the
    mesh while inflating ``actual_samples`` as little as possible.
    """
    if n_samples <= 0:
        raise ValueError("n_samples must be positive")
    if max_chunk_elems is None:
        max_chunk_elems = default_max_chunk_elems()
    total_threads = round_up(target_threads or DEFAULT_TARGET_THREADS, _LANE_MULTIPLE)
    loops = -(-n_samples // total_threads)  # ceil
    loops_per_chunk = max(1, min(loops, max_chunk_elems // total_threads))
    if n_dev > 1:
        # Prefer splitting work across devices over padding it.
        loops_per_chunk = min(loops_per_chunk, max(1, -(-loops // n_dev)))
    n_chunks = -(-loops // loops_per_chunk)
    if n_dev > 1:
        n_chunks = round_up(n_chunks, n_dev)
    actual = total_threads * loops_per_chunk * n_chunks
    return IntegratePlan(total_threads, loops_per_chunk, n_chunks, actual)
