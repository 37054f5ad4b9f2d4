"""The 95th percentile of the latency of all requests in the window: from
the call into the forward to the synchronize after it."""
from benchmark import readers


def read(run):
    if run.mode != "serve":
        return None
    p95 = readers.quantile(run.latency_s, 95)
    return None if p95 is None else p95 * 1e3
