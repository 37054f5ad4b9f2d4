"""GB allocated on the card at the entry of the program's ``step.backward``
span less at the entry of its ``step.forward``, in the last traced step:
what the forward and the losses hold for the backward
(``utils/profiling.py:counters``; a program without them reads nothing)."""
from benchmark import harness


def read(run):
    if run.mode != "train" or run.trace is None:
        return None
    counters = getattr(harness.port("utils.profiling"), "counters", {})
    at = [counters.get(f"step.{phase}.allocated_bytes") for phase in ("forward", "backward")]
    if None in at:
        return None
    return (at[1] - at[0]) / 1e9
