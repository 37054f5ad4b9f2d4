"""Profiling hooks: the counterpart of the JAX package's
``utils/profiling.py``.

The reference has no tracing at all — wall-clock prints every 5 iters
(SURVEY.md §5). Here:

* ``trace`` records the enclosed steps with ``torch.profiler`` (the CPU
  operators, and the card's kernels where a card is present) into a Chrome
  trace file that Perfetto and TensorBoard open;
* ``span(name)`` marks a part of the program (a phase of the train step, a
  part of the model) as the range ``pmt.<name>`` while a profiler records,
  so the range lands in the same trace as the card's kernels, on its clock;
* ``counters`` holds what a span counts while a profiler records: the bytes
  allocated on the card at the entry of the spans opened with
  ``allocated=True``, under ``<name>.allocated_bytes``.

With no profiler recording, ``span`` costs one check and returns one shared
no-op context: no torch op, no clock read, nothing written to ``counters``.

The JAX package's ``start_profiler_server`` (an endpoint TensorBoard
connects to and captures from on demand) has no torch counterpart:
``torch.profiler`` records only the region a program wraps in it. So it is
not ported; ``trace`` around the steps of interest takes its place.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch

PREFIX = "pmt."
counters: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


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


def span(name: str, allocated: bool = False):
    """The range ``pmt.<name>`` while a profiler records, else a shared no-op
    context. ``allocated``: also count the card's allocated bytes at its
    entry (no sync; the peak statistics are left alone)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if allocated:
        counters[f"{name}.allocated_bytes"] = (torch.cuda.memory_allocated()
                                               if torch.cuda.is_initialized() else 0)
    return torch.profiler.record_function(PREFIX + name)
