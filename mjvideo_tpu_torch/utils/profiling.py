"""Tracing, profiling and throughput counters.

Counterpart of ``mjvideo_tpu/utils/profiling.py`` on ``torch.profiler``:

* ``trace(logdir)``: a context manager that records the host's operators
  and, where CUDA is available, the card's kernels, and writes a Chrome
  trace (``trace.json``, for ``chrome://tracing`` or Perfetto) into
  ``logdir`` on exit; the profiler is yielded, so its ``key_averages()``
  can be read too.
* ``annotate(name)``: a named host region, shown in the trace
  (``torch.profiler.record_function``).
* ``Throughput``: the clips/s (or any unit/s) counter with exponential
  smoothing.
* ``StepTimer``: per-step wall time and metrics, appended as JSONL.

``Throughput`` and ``StepTimer`` keep JAX's semantics and records to the
digit.  JAX's ``enable_compilation_cache`` (its persistent compilation
cache) has no counterpart: the port compiles no graphs, and its kernels
are built once by ``kernels.build`` into ``build/kernels/<hash>/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where CUDA is available) and write its Chrome trace to
    ``logdir/trace.json`` on exit; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named trace region: ``with annotate("decode"): ...``."""
    return torch.profiler.record_function(name)


class Throughput:
    """clips/sec (or any unit/sec) counter with exponential smoothing."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rate: Optional[float] = None
        self.total = 0
        self._t0 = time.perf_counter()
        self._last = self._t0

    def update(self, n: int) -> float:
        now = time.perf_counter()
        dt = max(now - self._last, 1e-9)
        inst = n / dt
        self.rate = inst if self.rate is None else (
            self.ema * self.rate + (1 - self.ema) * inst
        )
        self.total += n
        self._last = now
        return self.rate

    def average(self) -> float:
        return self.total / max(time.perf_counter() - self._t0, 1e-9)


class StepTimer:
    """Per-step timing and metrics that appends JSONL records."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._t = time.perf_counter()

    def step(self, **metrics) -> dict:
        now = time.perf_counter()
        rec = {"step_time_s": round(now - self._t, 5), **metrics}
        self._t = now
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        return rec
