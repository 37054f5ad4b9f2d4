"""Kernels on the device per request, in the traced window."""
from benchmark import readers


def read(run):
    return readers.launches(run, "serve")
