"""The forward's operations per request at the untraced requests' rate, as a
share of the TF32 peak."""
from benchmark import readers


def read(run):
    return readers.mfu_pct(run, "serve")
