"""corr2d's forward kernel: its share of its roofline at the serving
site."""
from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "serve", "corr2d", backward=False)
