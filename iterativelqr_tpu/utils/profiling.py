"""Profiling helpers (SURVEY.md section 5 "tracing/profiling" row).

The reference has no profiling subsystem beyond a manual BenchmarkTools
scratchpad (reference: test/benchmark.jl).  Equivalents here:

* ``trace(logdir)`` — context manager around ``jax.profiler`` producing
  TensorBoard/Perfetto traces of device execution.
* ``annotate(name)`` — ``jax.named_scope`` wrapper so solver stages show up
  named in traces/HLO.
* ``time_stages(...)`` — see benchmarks/stage_bench.py for the per-stage
  timing harness (the analog of the reference's per-stage @benchmark list).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device profile: view with TensorBoard or ui.perfetto.dev."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope for solver stages (shows up in profiles and HLO)."""
    return jax.named_scope(name)


def timed(fn: Callable, *args, reps: int = 10, warmup: int = 2) -> float:
    """Steady-state wall-clock seconds per call (blocks on outputs)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps
