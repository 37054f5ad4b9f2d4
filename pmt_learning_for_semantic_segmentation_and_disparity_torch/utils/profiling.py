"""Profiling hooks: the counterpart of the JAX package's
``utils/profiling.py``.

The reference has no tracing at all — wall-clock prints every 5 iters
(SURVEY.md §5). Here: ``trace`` records the enclosed steps with
``torch.profiler`` (the CPU operators, and the card's kernels where a card
is present) into a Chrome trace file that Perfetto and TensorBoard open,
plus a tiny step timer.

The JAX package's ``start_profiler_server`` (an endpoint TensorBoard
connects to and captures from on demand) has no torch counterpart:
``torch.profiler`` records only the region a program wraps in it. So it is
not ported; ``trace`` around the steps of interest takes its place.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed steps into
    ``log_dir/trace.json`` (Chrome trace format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time statistics (replaces the reference's raw
    time.time() prints, torch_implementation.py:346-379)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._last: Optional[float] = None
        self._count = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def throughput(self, batch: int) -> float:
        return batch / self.mean if self.mean > 0 else 0.0
