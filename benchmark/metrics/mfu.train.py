"""A train step's operations at the untraced steps' rate, as a share of the
TF32 peak."""
from benchmark import readers


def read(run):
    return readers.mfu_pct(run, "train")
