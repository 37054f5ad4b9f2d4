"""corr1d's forward kernel: its share of its roofline at the training
site."""
from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "train", "corr1d", backward=False)
