"""Everything before the window: process start, the program's import and
model, the weights and batches from the seed, the warm-up (and, in a first
run, the kernels' build)."""


def read(run):
    return run.setup_s
