"""The port's spans (``utils/profiling.py:span``) on the CPU, torch only: the
train step's phases and the model's trunk and correlation as ``pmt.`` ranges
under a profiler, and nothing at all without one. The nets run with their
DenseNet trunk cut to one layer a block (widths, pyramid and heads whole),
on one pair of 32x64.

* Without a profiler, ``span`` hands out one shared no-op context, and a
  train step writes nothing to ``profiling.counters``.
* Under ``torch.profiler``, one train step of the flagship opens
  ``pmt.step.forward``, ``.losses``, ``.backward``, ``.metrics`` and
  ``.optimizer`` in that order without overlap, after the ``zero_grad`` in a
  ``pmt.step.optimizer`` of its own, with ``pmt.model``,
  ``pmt.model.trunk`` and ``pmt.model.correlation`` inside the forward, and
  counts the bytes allocated at the forward's and the backward's entry.
* A forward of each net the benchmark runs, under ``profiling.trace``,
  writes those model ranges into the Chrome trace file.
"""
import json

import pytest
import torch
from port_threads import torch_threads  # noqa: F401
from torch.profiler import ProfilerActivity, profile

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config_from_args
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core.registry import BACKBONES
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import densenet, get_network
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    TrainState,
    build_optimizer,
    make_forward_fn,
    make_train_step,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import profiling

NETS = {"flagship": "-net sdnet_mini_ext -corrType 1dcorr -loss cross_entropy lovasz_loss",
        "sdnet": "-net sdnet -corrType 2dcorr -loss cross_entropy lovasz_loss"}
PHASES = ["pmt.step.forward", "pmt.step.losses", "pmt.step.backward", "pmt.step.metrics",
          "pmt.step.optimizer"]
MODEL = ["pmt.model", "pmt.model.trunk", "pmt.model.correlation"]


def _cfg(net):
    return config_from_args((NETS[net] + " -backbone densenet -optimType adam -output_activation "
                             "linear -datasetName roses").split())


@pytest.fixture(scope="module")
def shallow():
    """The DenseNet trunk at one layer a block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(BACKBONES._items, "densenet",
                   lambda in_channels=3: densenet.DenseNetFeatures((1, 1, 1, 1), 32, 64, in_channels))
        yield


def _batch():
    g = torch.Generator().manual_seed(3)
    seg = torch.nn.functional.one_hot(torch.randint(0, 2, (1, 32, 64), generator=g), 2).float()
    return {"left": torch.rand(1, 32, 64, 3, generator=g),
            "right": torch.rand(1, 32, 64, 3, generator=g),
            "seg": seg, "disp": torch.rand(1, 32, 64, 1, generator=g)}


def _train_step(net):
    cfg = _cfg(net)
    model = get_network(cfg, device="cpu")
    tx = build_optimizer(cfg.optim, cfg.model.net, len(cfg.loss.losses))
    return make_train_step(cfg, model, "cpu"), TrainState.create(model, tx)


def test_no_profiler_no_spans_and_no_counters(shallow):
    assert not torch.autograd._profiler_enabled()
    shared = profiling.span("step.forward")
    assert profiling.span("model.trunk") is shared
    assert profiling.span("step.backward", allocated=True) is shared
    profiling.counters.clear()
    step, state = _train_step("flagship")
    step(state, _batch())
    assert profiling.counters == {}


def test_a_train_step_opens_the_phases_in_order(shallow):
    step, state = _train_step("flagship")
    batch = _batch()
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.name.startswith(profiling.PREFIX))
    phases = [r for r in ranges if r[2] in PHASES]
    # zero_grad opens the step in the optimizer's span, the update closes it
    assert [name for _, _, name in phases] == PHASES[-1:] + PHASES
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))  # no overlap
    forward = phases[1]
    inside = {name for start, end, name in ranges if forward[0] <= start and end <= forward[1]}
    assert inside == {forward[2], *MODEL}
    assert {"step.forward.allocated_bytes", "step.backward.allocated_bytes"} == set(
        profiling.counters)


@pytest.mark.parametrize("net", sorted(NETS))
def test_the_trace_file_holds_the_model_spans(shallow, tmp_path, net):
    cfg = _cfg(net)
    forward = make_forward_fn(cfg, get_network(cfg, device="cpu"), "cpu")
    with torch.no_grad(), profiling.trace(str(tmp_path)):
        forward(_batch())
    with open(tmp_path / "trace.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert sorted(n for n in names if n.startswith(profiling.PREFIX)) == sorted(MODEL)
