"""The program's spans and counter as the benchmark reads them: the
reduction of ``spans.py``, kernels put down to the span that held their
launch, on made-up events; and a traced run on the CPU prints every metric
of the program's spans and counter that its cell lists."""
import math

import pytest

from benchmark import harness, spans

from .conftest import cells, tiny

SPAN_SOURCES = ("program_span", "program_counter")


def span(name, start, end):
    return (name, False, True, start, end, 0)


def launch(corr, at, name="cudaLaunchKernel"):
    return (name, False, False, at, at + 1e-6, corr)


def kernel(corr, seconds, name="void conv_kernel"):
    return (name, True, False, 100.0, 100.0 + seconds, corr)


def test_a_kernel_counts_in_the_span_that_held_its_launch():
    events = [
        span("bench.iteration", 0.0, 10.0), span("bench.dispatch", 0.0, 9.0),
        span("pmt.step.forward", 1.0, 3.0), span("pmt.model", 1.5, 2.8),
        span("pmt.model.trunk", 1.6, 2.0), span("pmt.step.backward", 4.0, 8.0),
        # the model's own kernel, one in the trunk, one in the forward outside the model
        launch(1, 2.5), kernel(1, 0.25), launch(2, 1.7), kernel(2, 0.5), launch(3, 1.2),
        kernel(3, 0.125),
        # launched by autograd's thread, the main thread waiting inside step.backward
        launch(4, 6.0, "cudaLaunchKernelExC"), kernel(4, 2.0),
        # launched before any span: counts nowhere
        launch(5, -1.0), kernel(5, 4.0),
        # a host operator whose id coincides with a launch's is not that launch
        ("aten::as_strided", False, False, 8.5, 8.6, 4),
        # memsets and the spans' own device ranges are not kernels
        launch(6, 2.5, "cudaMemsetAsync"), kernel(6, 1.0, "Memset (Device)"),
        ("pmt.model", True, True, 100.0, 101.0, 0),
    ]
    out = spans.reduce(events, 2)
    assert out["pmt.model.trunk"].device_s == out["pmt.model.trunk"].self_s == 0.25
    assert (out["pmt.model"].device_s, out["pmt.model"].self_s) == (0.375, 0.125)
    assert (out["pmt.step.forward"].device_s, out["pmt.step.forward"].self_s) == (0.4375, 0.0625)
    assert out["pmt.step.forward"].launches == 1.5
    assert out["pmt.step.backward"].device_s == out["pmt.step.backward"].self_s == 1.0
    assert out["bench.iteration"].device_s == 1.4375 and out["bench.iteration"].self_s == 0.0
    assert out["pmt.step.forward"].host_s == 1.0 and out["pmt.model"].host_s == pytest.approx(0.65)
    assert sum(s.self_s for s in out.values()) == 1.4375  # the kernel launched outside is gone


def test_spans_of_one_name_add_up_and_no_span_reads_nothing():
    events = [span("pmt.model.correlation", 0.0, 1.0), span("pmt.model.correlation", 2.0, 2.5),
              launch(1, 0.5), kernel(1, 0.5), launch(2, 2.1), kernel(2, 0.25)]
    out = spans.reduce(events, 1)
    assert out["pmt.model.correlation"].device_s == 0.75
    assert out["pmt.model.correlation"].host_s == 1.5
    assert spans.reduce([launch(1, 0.5), kernel(1, 0.5)], 1) == {}


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    import types

    from benchmark import trace

    read = harness.reader("activation_gb.train")
    run = harness.Run(mode="train", net="sdnet", labels=2, losses=[], batch=1, height=8, width=8)
    run.trace = trace.Trace(1.0, 1, [], 1.0)
    monkeypatch.setattr(harness, "port", lambda module: types.SimpleNamespace())  # the parent's
    assert read(run) is None
    counters = {"step.forward.allocated_bytes": 1e9, "step.backward.allocated_bytes": 3.5e9}
    monkeypatch.setattr(harness, "port", lambda module: types.SimpleNamespace(counters=counters))
    assert read(run) == 2.5
    run.mode = "serve"
    assert read(run) is None


@pytest.mark.parametrize("name", cells("train"))
def test_a_traced_run_prints_the_span_metrics(name):
    # iteration 0 runs untraced, 1 in the device segment, 2 in the host segment
    cell = tiny(harness.load_cell(name), trace_iterations=1, batch=1)
    result = harness.run_cell(cell, 2**35 + 9, 6.0, True, device="cpu")
    assert result["attempted"] >= 3
    listed = [m["name"] for m in cell.per_layer if m["source"] in SPAN_SOURCES]
    assert listed == ["activation_gb.train"]
    for m in listed:
        value = result["metrics"][m]["value"]
        assert math.isfinite(value) and value >= 0, m
