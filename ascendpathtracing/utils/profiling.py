"""Profiling / observability.

The reference's only observability is a per-tile progress printf
(render.cpp:53-54) and simulator waveforms (SURVEY §5).  Here:

- :func:`trace` — contextmanager around ``jax.profiler`` producing a
  TensorBoard/XProf trace directory.
- :func:`benchmark` — compile-excluded steady-state step time, each step
  fenced with ``jax.block_until_ready``.
- :func:`mrays` — the throughput metric helper.
"""

from __future__ import annotations

import contextlib
import statistics
import time


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in xprof/TensorBoard."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *, iters: int = 10, warmup: int = 2):
    """Steady-state timing of ``fn(i)`` (the argument lets callers vary a
    seed so no step repeats another's inputs).

    The first ``warmup`` calls compile and warm up and are not timed.
    Each timed step waits for its result with ``jax.block_until_ready``,
    so a step's time includes its device work and not only the enqueue.
    Returns dict: step_s (median), min_s, max_s, iters, times, out (the
    last output)."""
    import jax

    out = None
    for i in range(max(warmup, 1)):
        out = jax.block_until_ready(fn(i))
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(warmup + i))
        times.append(time.perf_counter() - t0)
    return {
        "step_s": statistics.median(times),
        "min_s": min(times),
        "max_s": max(times),
        "iters": iters,
        "times": times,
        "out": out,
    }


def mrays(n_rays: int, seconds: float) -> float:
    """Primary Mrays/s (the benchmark metric counts primary rays)."""
    return n_rays / max(seconds, 1e-12) / 1e6
