"""All pairs of the train steps completed in the window, each ending in a
synchronize, over the window's length."""
from benchmark import readers


def read(run):
    return readers.pairs_per_s(run, "train")
