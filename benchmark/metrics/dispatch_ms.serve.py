"""Host ms from the call into the forward to its return, before the sync:
the median over the trace run's untraced requests."""
from benchmark import readers


def read(run):
    return readers.dispatch_ms(run, "serve")
