"""Device ms per request in the convolution family."""
from benchmark import readers


def read(run):
    return readers.family_ms(run, "serve", ("convolution",))
