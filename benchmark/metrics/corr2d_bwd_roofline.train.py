"""corr2d's backward (the relayout and the band kernel): its share of its
roofline at the training site."""
from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "train", "corr2d", backward=True)
