"""The share of the traced window's wall time covered by no device
operation, training."""
from benchmark import readers


def read(run):
    return readers.idle_pct(run, "train")
