"""Device ms per train step in the convolution family."""
from benchmark import readers


def read(run):
    return readers.family_ms(run, "train", ("convolution",))
