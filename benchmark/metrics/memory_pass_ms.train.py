"""Device ms per train step in the batch_norm, elementwise, concatenate and
resize families."""
from benchmark import readers, yardstick


def read(run):
    return readers.family_ms(run, "train", yardstick.MEMORY_PASSES)
