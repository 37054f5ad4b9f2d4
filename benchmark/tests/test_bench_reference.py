"""The plain reference against the program at a tiny size on the CPU, in
float64 so that rounding is far below what any difference in the
mathematics would show: the eval forward's four outputs, and the first three
train steps (losses, the first gradient, the parameters' change)."""
import pytest
import torch

from benchmark import check, harness

from .conftest import cells, tiny


def setup(name, seed=11):
    cell = tiny(harness.load_cell(name))
    weights, pool = harness.inputs_of(cell, seed, "cpu", torch.float64)
    return cell, cell.flag("-net"), cell.config["labels"], weights, pool


@pytest.mark.parametrize("name", cells("serve"))
def test_eval_forward_matches(name):
    cell, net, labels, weights, pool = setup(name)
    forward = harness.mode_of(cell).build(cell, weights, "cpu").call
    with torch.inference_mode():
        prog = forward(pool[0])
        ref = check.reference_outputs(check.reference_net(net, labels, weights, "cpu"), pool[0])
    for k in check.OUTPUTS:
        assert prog[k].shape == ref[k].shape
    assert check.out_gap(prog, ref) < 1e-10


@pytest.mark.parametrize("name", cells("train"))
def test_first_steps_match(name):
    cell, net, labels, weights, pool = setup(name)
    built = harness.mode_of(cell).build(cell, weights, "cpu")
    model = built.model
    prog, _ = check.program_first_steps(built.call, built.state, model, pool, weights)
    ref = check.reference_first_steps(net, labels, cell.losses(), weights, pool, "cpu")
    assert set(prog.grad_norms) == set(ref.grad_norms) == {n for n, _ in model.named_parameters()}
    gaps = check.compare_train(prog, ref)
    assert abs(prog.losses[0] - ref.losses[0]) < 1e-9 * ref.losses[0]
    # MultiTversky's backward runs in fp32 inside the program (``.float()``):
    # ~1e-7 of its share of the first gradient
    assert gaps["grad_gap"] < 1e-5, gaps
    if "tversky_loss" not in cell.losses():
        # steps 2 and 3 at this size (BatchNorm over a few pixels a channel)
        # carry float64's rounding of step 1 up to ~1e-4 of a parameter's change
        assert gaps["loss_gap_3"] < 1e-6 and gaps["change_gap"] < 1e-3, gaps
        assert gaps["change_med_gap"] < 1e-5, gaps
    # with it, Adam's first update moves parameters whose gradient is near
    # its eps by ~1e-6 apart, and steps 2 and 3 carry that far: the losses
    # of those steps are held in float64 on the flagship's stack alone
