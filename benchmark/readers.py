"""What the metric readers under ``metrics/`` share. A reader is a file
``metrics/<metric name>.py`` with ``read(run) -> float | None``; ``run`` is
the ``harness.Run`` of the cell. A reader that finds nothing to read returns
None, and the harness leaves the metric out of the line. Shares of a peak
are never clipped: a reading over 100% means the counts or the time are
wrong.
"""
from __future__ import annotations

import statistics
from typing import Optional

from . import yardstick


def quantile(values, q: int) -> Optional[float]:
    """The q-th percentile of ``values`` (``statistics.quantiles``, n=100)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[q - 1]


def pairs_per_s(run, mode: str) -> Optional[float]:
    """All pairs of the iterations completed in the window over its length."""
    if run.mode != mode or run.window_s <= 0:
        return None
    return run.iterations * run.batch / run.window_s


def launches(run, mode: str) -> Optional[float]:
    """Kernels in the traced window per iteration."""
    if run.mode != mode or run.trace is None or not run.trace.iterations:
        return None
    return len(run.trace.kernels) / run.trace.iterations


def dispatch_ms(run, mode: str) -> Optional[float]:
    """Median host time from the call into the program to its return, before
    the sync, over the trace run's untraced iterations."""
    if run.mode != mode or run.trace is None or len(run.untraced_dispatch_s) < 2:
        return None
    return statistics.median(run.untraced_dispatch_s) * 1e3


def family_ms(run, mode: str, families) -> Optional[float]:
    """Device ms per iteration in the kernel ``families``."""
    if run.mode != mode or run.trace is None or not run.trace.iterations:
        return None
    fams = run.trace.family_seconds()
    if not any(f in fams for f in families):
        return None
    return sum(fams.get(f, 0.0) for f in families) / run.trace.iterations * 1e3


def roofline_pct(run, mode: str, kernel: str, backward: bool) -> Optional[float]:
    """The share of the roofline of ``kernel``'s forward or backward: its
    least possible time at the cell's correlation sites, times the calls in
    the traced window, over its measured time there."""
    if run.mode != mode or run.trace is None or not run.trace.iterations:
        return None
    fam = f"{kernel}_backward" if backward else kernel
    seconds = run.trace.family_seconds().get(fam, 0.0)
    sites = [shape for k, shape in run.corr_sites() if k == kernel]
    if seconds <= 0 or not sites:
        return None
    least = sum(yardstick.bound_s(*yardstick.corr_bytes_flops(kernel, s, run.dtype, backward),
                                  run.dtype) for s in sites)
    return 100.0 * least * run.trace.iterations / seconds


def idle_pct(run, mode: str) -> Optional[float]:
    """The share of the traced window covered by no device operation."""
    if run.mode != mode or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run, mode: str) -> Optional[float]:
    """The model's operations per iteration over the untraced iterations'
    time, as a share of the peak of the cell's type (fp32: TF32's, at which
    the program's convolutions run)."""
    if run.mode != mode or run.trace is None or not run.untraced_latency_s:
        return None
    rate = len(run.untraced_latency_s) * run.flops() / sum(run.untraced_latency_s)
    return 100.0 * rate / yardstick.PEAK_FLOPS[run.dtype]
