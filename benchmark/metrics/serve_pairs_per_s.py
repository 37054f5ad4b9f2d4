"""All stereo pairs whose outputs completed in the window, over the window's
length."""
from benchmark import readers


def read(run):
    return readers.pairs_per_s(run, "serve")
