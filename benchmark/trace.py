"""Reduction of a ``--trace 1`` run's ``torch.profiler`` traces, read in
memory, to what the per-layer metrics read. ``harness.window`` traces two
segments of ``trace_iterations`` iterations each:

* the device segment, profiled with the device's activity alone, so that
  the host dispatches as fast as untraced: its device operations, the union
  of their intervals (busy time) and its kernels. Its window runs from its
  first device operation's start to its last one's end; every iteration
  ends in a synchronize, so the device's work of those iterations lies
  inside it, and the host's time between them shows as idle (all but the
  lead of the first iteration);
* the host segment, profiled with the host's operations too, which slows
  the host: its idle gaps, each named by the benchmark span the host was in
  and the outermost operation running on the host at its middle. It is
  read for those names alone.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .yardstick import family_seconds

OWN_PREFIX = "bench."  # the benchmark's own spans (record_function)


@dataclass
class Trace:
    window_s: float
    iterations: int
    kernels: List[Tuple[str, float, float]]  # (name, start_s, end_s), kernels only
    busy_s: float                            # union of all device operations
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host activity, seconds)

    def family_seconds(self) -> Dict[str, float]:
        return family_seconds(self.kernels)


def _raw_events(prof):
    """(name, is_device, is_annotation, start_s, end_s) of every event."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() != DeviceType.CPU, e.is_user_annotation(),
               e.start_ns() * 1e-9, e.end_ns() * 1e-9)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _gaps(busy: List[Tuple[float, float]], w0: float, w1: float) -> List[Tuple[float, float]]:
    gaps, last = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    return gaps


def _name_points(points: List[float], own: List[Tuple[str, float, float]],
                 ops: List[Tuple[str, float, float]]) -> List[str]:
    """For each time in ``points`` (sorted): the innermost own span and the
    longest host operation that contain it, as 'span:operation'. Own spans
    are a few an iteration; host operations many, swept once."""
    names = []
    ops = sorted(ops, key=lambda t: t[1])
    j = 0
    active: List[Tuple[float, float, str]] = []  # (-duration, end, name): longest first
    for p in points:
        while j < len(ops) and ops[j][1] <= p:
            heapq.heappush(active, (-(ops[j][2] - ops[j][1]), ops[j][2], ops[j][0]))
            j += 1
        while active and active[0][1] < p:  # the longest has ended: it can end no other
            heapq.heappop(active)
        spans = [(s, n) for n, s, e in own if s <= p <= e]
        span = max(spans)[1] if spans else "none"
        op = active[0][2] if active else "none"
        names.append(f"{span}:{op}"[:120])
    return names


def _device_segment(prof, iterations: int) -> Trace:
    device = [(n, s, e) for n, is_device, annotation, s, e in _raw_events(prof)
              if is_device and not annotation]
    if not device or not iterations:
        return Trace(0.0, 0, [], 0.0)
    w0, w1 = min(s for _, s, _ in device), max(e for _, _, e in device)
    kernels = [k for k in device if not k[0].startswith(("Memcpy", "Memset"))]
    busy = _union([(s, e) for _, s, e in device])
    return Trace(window_s=w1 - w0, iterations=iterations, kernels=kernels,
                 busy_s=sum(e - s for s, e in busy))


def _named_gaps(prof, max_gaps: int = 4000) -> List[Tuple[str, float]]:
    """The host segment's idle gaps by what the host was doing, summed,
    longest first."""
    device, own, ops = [], [], []
    for name, is_device, annotation, start, end in _raw_events(prof):
        if is_device:
            if not annotation:
                device.append((start, end))
        elif annotation and name.startswith(OWN_PREFIX):
            own.append((name, start, end))
        elif not annotation or not name.startswith("ProfilerStep"):
            ops.append((name, start, end))
    iterations = [(s, e) for n, s, e in own if n == f"{OWN_PREFIX}iteration"]
    if not iterations:
        return []
    w0, w1 = min(s for s, _ in iterations), max(e for _, e in iterations)
    busy = _union([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1])
    gaps = sorted(_gaps(busy, w0, w1), key=lambda g: g[0] - g[1])[:max_gaps]
    gaps.sort()
    by_name: Dict[str, float] = {}
    for name, (s, e) in zip(_name_points([(s + e) / 2 for s, e in gaps], own, ops), gaps):
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def reduce(profs: Sequence, iterations: Sequence[int]) -> Trace:
    """The ``Trace`` of the device segment ``profs[0]`` (``iterations[0]``
    iterations), with the idle gaps of the host segment ``profs[1]`` where
    it ran."""
    trace = _device_segment(profs[0], iterations[0])
    if len(profs) > 1 and iterations[1]:
        trace.gaps = _named_gaps(profs[1])
    return trace


def breakdown(trace: Trace, top: int = 10) -> dict:
    fams = sorted(trace.family_seconds().items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in fams],
            "idle_gaps": [[n, s] for n, s in trace.gaps[:top]]}
