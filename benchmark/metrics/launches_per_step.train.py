"""Kernels on the device per train step, in the traced window."""
from benchmark import readers


def read(run):
    return readers.launches(run, "train")
