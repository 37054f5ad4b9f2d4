"""Reduction of a host segment's events (what ``trace.reduce`` receives as
``profs[1]``) to totals by span, a traced iteration: the program's spans
(``pmt.``, from its ``utils/profiling.py:span``) and the benchmark's own
(``bench.``). No metric reads it yet: ``trace.Trace`` has no field to carry
these totals to the readers.

Each kernel is put down to the runtime call that launched it
(``cudaLaunchKernel`` and its kin, matched by correlation id), and so to
the spans whose interval holds that call, on whatever host thread it ran:
autograd launches the backward's kernels from a thread of its own while
the main thread waits inside ``step.backward``. A kernel whose launch no
span holds counts nowhere. A span's

* ``device_s``: its kernels' summed time (as ``family_ms`` sums), nested
  spans' kernels included;
* ``self_s``: the time of the kernels whose innermost span it is (a span
  nested in it holds the rest);
* ``host_s``: its duration;
* ``launches``: its kernels, nested spans' included.

The reduction takes plain event tuples, so that it can be fed made-up
events.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

PREFIXES = ("pmt.", "bench.")
# host events that carry a launch's correlation id; the host's operators
# carry ids of another series, which may coincide with those
RUNTIME = ("cuda", "cu")
NOT_KERNELS = ("Memcpy", "Memset")

Event = Tuple[str, bool, bool, float, float, int]


@dataclass
class Span:
    device_s: float = 0.0
    self_s: float = 0.0
    host_s: float = 0.0
    launches: float = 0.0


def events(prof) -> Iterable[Event]:
    """(name, is_device, is_annotation, start_s, end_s, correlation_id) of
    every event of a profiler."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() != DeviceType.CPU, e.is_user_annotation(),
               e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.correlation_id())


def reduce(evs: Iterable[Event], iterations: int) -> Dict[str, Span]:
    """Totals by span name over ``iterations`` traced iterations, divided by
    their number."""
    spans, launch_at, kernels = [], {}, []
    for name, is_device, annotation, start, end, corr in evs:
        if is_device:
            if not annotation and not name.startswith(NOT_KERNELS):
                kernels.append((corr, end - start))
        elif annotation:
            if name.startswith(PREFIXES):
                spans.append((start, end, name))
        elif name.startswith(RUNTIME) and "::" not in name and corr:
            launch_at[corr] = start
    if not spans or not iterations:
        return {}
    out = {name: Span() for _, _, name in spans}
    for start, end, name in spans:
        out[name].host_s += end - start
    launched = sorted((launch_at[corr], seconds) for corr, seconds in kernels if corr in launch_at)
    spans.sort()
    j, active = 0, []
    for t, seconds in launched:
        while j < len(spans) and spans[j][0] <= t:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] >= t]
        for _, _, name in active:
            out[name].device_s += seconds
            out[name].launches += 1
        if active:  # of those holding t, the innermost opened last and closes first
            out[max(active, key=lambda s: (s[0], -s[1]))[2]].self_s += seconds
    for span in out.values():
        span.device_s /= iterations
        span.self_s /= iterations
        span.host_s /= iterations
        span.launches /= iterations
    return out

