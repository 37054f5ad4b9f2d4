"""Host ms from the call into the train step to its return, before the sync:
the median over the trace run's untraced steps."""
from benchmark import readers


def read(run):
    return readers.dispatch_ms(run, "train")
