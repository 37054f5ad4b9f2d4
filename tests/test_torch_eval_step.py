"""The port's eval path against the JAX package's, on the CPU.

* ``eval_rows`` (the per-row ``_eval_metrics_full`` plus the per-row losses
  of ``make_losses_fn``) fed the same outputs as the JAX package's per-row
  step (``_eval_metrics_full`` and its losses, vmapped over rows), with a
  padded bucket: confusion matrices and pixel counts equal, every other
  leaf within 1e-5 relative (1e-6 absolute).
* The whole ``make_eval_step`` of the flagship (bench loss stack) with the
  trunk at ``reduced_depth()``, fp32, 3 rows of 56x120 in a 64x128 bucket,
  the last row a padded repeat (``valid`` 2), against the JAX
  ``make_eval_step(cfg, model)`` with the same weights (the port's seeded
  weights as a flax tree, carried back into a second port model by
  ``load_jax_variables``): outputs within 1e-3 * max|ref|, per-row loss
  logs within 1e-4 relative, pixel counts equal, and the padded row's
  metrics those of the row it repeats.
* ``tiled_inference`` against the JAX one on a cheap elementwise
  ``apply_fn``, in both modes: within 1e-6 relative.
* ``MetricAccumulator`` against the JAX one on the same rows: summaries
  within 1e-12 relative, tables and mean±std strings equal.
* ``parallel/spatial.py``: ``split_bands``/``merge_bands`` equal to the
  JAX package's exactly, and ``spatial_shard_infer`` over the flagship above
  (1x64x128 in two bands with a 16-row halo, batched as 2x64x128) within
  1e-3 * max|ref| of the JAX package's over the same weights.
* ``utils/viz.py:show_results`` with matplotlib hidden: one decodable PNG a
  sample, six panels in a 2 x 3 grid, the seg panels the JAX package's
  ``decode_segmap`` of the argmax, the disparity and error panels their
  colour maps.
* ``utils/viz.py:colorize`` against the mapping the JAX package's panels
  and confusion heatmap draw with, ``imshow``'s (matplotlib's ``Normalize``
  over the panel's range, then its ``jet``, ``Blues`` or ``magma``), on
  values at the maps' 256 levels: jet and Blues within 0.5 of 255 (the
  rounding to uint8), magma within 3 (its 256 colours interpolated between
  17 of them). The JAX package's figures add titles, axes and a resampling
  to the figure's size, so its PNGs are not compared pixel for pixel.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import reduced_depth, torch_threads, variables_from_port  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import pad_to_bucket, png
from pmt_learning_for_semantic_segmentation_and_disparity_torch.evaluation import (
    MetricAccumulator,
    tiled_inference,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import spatial as tspatial
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import step as tstep
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import viz as tviz
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.evaluation import (
    MetricAccumulator as JaxAccumulator,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.evaluation import (
    tiled_inference as jax_tiled_inference,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.data.labels import decode_segmap
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.parallel import spatial as jspatial
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training import step as jstep
from torch_port import STACK, port_config

EXACT = ("conf1", "conf2", "disp_err3px", "disp_valid")
LOSSES = ("loss", "loss_seg", "loss_disp")


def jax_config(net="sdnet_mini_ext"):
    cfg = JaxConfig()
    cfg.model.net = net
    cfg.loss.losses = STACK
    return cfg


def sample_rows(rng, n, hw, bucket, labels=2):
    """``n`` random rows of ``hw`` (images, one-hot labels, disparity,
    edges), the last repeated once as a padded tail, padded to ``bucket``."""
    shape = (n,) + hw
    rows = {"left": rng.standard_normal(shape + (3,), dtype=np.float32),
            "right": rng.standard_normal(shape + (3,), dtype=np.float32),
            "seg": np.eye(labels, dtype=np.float32)[rng.integers(0, labels, shape)],
            "disp": rng.random(shape + (1,), dtype=np.float32) * 2 + 0.05,
            "edges": (rng.random(shape + (1,)) > 0.8).astype(np.float32)}
    rows = {k: np.concatenate([v, v[-1:]]) for k, v in rows.items()}
    return pad_to_bucket(rows, bucket)


def jax_rows(cfg, out, batch):
    """The JAX package's per-row eval metrics and losses (``make_eval_step``'s
    ``_row``, vmapped), jitted."""
    losses = jstep.make_losses_fn(cfg)
    rng = jax.random.PRNGKey(0)

    def row(o, b):
        o, b = ({k: v[None] for k, v in d.items()} for d in (o, b))
        m = jstep._eval_metrics_full(cfg, o, b)
        m.update(losses(o, b, rng)[1])
        return m

    return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(row))(out, batch).items()}


def hold_rows(got, ref, rtol=1e-5):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.shape == r.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-6, err_msg=k)


def test_eval_rows_match_jax():
    rng = np.random.default_rng(0)
    batch = sample_rows(rng, 3, (40, 56), (48, 64))
    out = {k: rng.standard_normal(batch["seg"].shape, dtype=np.float32) * 3 for k in ("seg1", "seg2")}
    out.update(disp1=rng.random(batch["disp"].shape, dtype=np.float32) * 2,
               disp2=rng.random(batch["disp"].shape, dtype=np.float32))
    cfg = port_config()
    got = tstep.eval_rows(cfg, tstep.make_losses_fn(cfg), {k: torch.from_numpy(v) for k, v in out.items()},
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jax_rows(jax_config(), out, batch)
    hold_rows(got, ref)
    assert got["disp_valid"].tolist() == [40 * 56] * 4  # the bucket's padding is masked


@pytest.fixture(scope="module")
def flagship_eval():
    rng = np.random.default_rng(1)
    batch = sample_rows(rng, 2, (56, 120), (64, 128))
    key = jax.random.PRNGKey(0)
    with reduced_depth():
        cfg = port_config()
        seeded = tmodels.get_network(cfg, device="cpu", seed=0)
        jcfg = jax_config()
        model = jmodels.get_network(jcfg)
        variables = variables_from_port(
            seeded, lambda k, a, b: model.init({"params": k}, a, b, train=False),
            key, batch["left"], batch["right"])
        ref_out, ref_rows = jstep.make_eval_step(jcfg, model)(
            variables["params"], variables["batch_stats"], batch, key)
        port = tmodels.get_network(cfg, device="cpu", seed=1)
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    out, rows = tstep.make_eval_step(cfg, port, device="cpu")(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"model": model, "variables": variables, "port": port,
            "ref_out": {k: np.asarray(v) for k, v in ref_out.items()},
            "ref_rows": {k: np.asarray(v) for k, v in ref_rows.items()},
            "out": {k: v.numpy() for k, v in out.items()},
            "rows": {k: v.numpy() for k, v in rows.items()}}


@pytest.mark.parametrize("key", ["seg1", "seg2", "disp1", "disp2"])
def test_flagship_eval_step_outputs_match_jax(flagship_eval, key):
    ref, got = flagship_eval["ref_out"][key], flagship_eval["out"][key]
    assert got.shape == ref.shape == (3, 64, 128, 1 if key.startswith("disp") else 2)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_flagship_eval_step_rows_match_jax(flagship_eval):
    got, ref = flagship_eval["rows"], flagship_eval["ref_rows"]
    assert set(got) == set(ref)
    for k in LOSSES:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["disp_valid"], ref["disp_valid"])
    assert got["disp_valid"].tolist() == [56 * 120] * 3
    for k, v in got.items():  # the padded row reports the row it repeats
        assert v.shape[0] == 3, k
        np.testing.assert_allclose(v[2], v[1], rtol=1e-6, atol=1e-6, err_msg=k)


def _cheap(lib):
    def apply_fn(left, right):
        return {"seg1": left[..., :2] * 2 + right[..., 1:3],
                "seg2": left[..., 1:3] - right[..., :2],
                "disp1": left[..., :1] * right[..., 2:3]}
    return apply_fn


@pytest.mark.parametrize("mode", [1, 2])
def test_tiled_inference_matches_jax(mode):
    window, stride, soft, hw = (((256, 512), (128, 256), False, (300, 600)) if mode == 1
                                else ((512, 512), (256, 256), True, (600, 700)))
    rng = np.random.default_rng(mode)
    left, right = (rng.standard_normal((2,) + hw + (3,), dtype=np.float32) for _ in range(2))
    got = tiled_inference(_cheap(torch), torch.from_numpy(left), torch.from_numpy(right),
                          window=window, stride=stride, softmax_seg=soft)
    ref = jax_tiled_inference(_cheap(jnp), jnp.asarray(left), jnp.asarray(right),
                              window=window, stride=stride, softmax_seg=soft)
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-6, atol=1e-6 * np.abs(r).max(), err_msg=k)


def test_metric_accumulator_matches_jax():
    rng = np.random.default_rng(2)
    port, ref = MetricAccumulator(), JaxAccumulator()
    for _ in range(5):
        row = {k: rng.random() for k in ("pixel_acc1", "pixel_acc2", "prec1", "prec2", "recall1",
                                          "recall2", "f1_1", "f1_2", "bf1_1", "bf1_2", "loss")}
        row.update(disp_err3px=float(rng.integers(0, 100)), disp_valid=float(rng.integers(100, 200)),
                   conf1=rng.integers(0, 50, (2, 2)).astype(np.float32),
                   conf2=rng.integers(0, 50, (2, 2)).astype(np.float32))
        assert port.update(dict(row)) == ref.update(dict(row))
        assert port.table(step_row=port.rows[-1]) == ref.table(step_row=ref.rows[-1])
    names = ["Background", "Branch"]
    got, want = port.summary(class_names=names), ref.summary(class_names=names)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    assert port.mean_and_std() == ref.mean_and_std()
    assert port.final_table() == ref.final_table()


def test_split_and_merge_bands_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 48, 20, 3), dtype=np.float32)
    got, meta, full = tspatial.split_bands(torch.from_numpy(x), 3, halo=8)
    ref, jmeta, jfull = jspatial.split_bands(jnp.asarray(x), 3, halo=8)
    assert (meta, full) == (jmeta, jfull) and got.shape == (6, 32, 20, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    merged = tspatial.merge_bands(got, meta, full, halo=8)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jspatial.merge_bands(ref, jmeta, jfull, halo=8)))
    np.testing.assert_array_equal(merged.numpy(), x)


def test_spatial_shard_infer_matches_jax(flagship_eval):
    rng = np.random.default_rng(5)
    left, right = (rng.standard_normal((1, 64, 128, 3), dtype=np.float32) for _ in range(2))
    model, variables, port = (flagship_eval[k] for k in ("model", "variables", "port"))
    with reduced_depth():
        apply = jax.jit(lambda a, b: model.apply(variables, a, b, train=False))
        ref = jspatial.spatial_shard_infer(apply, jnp.asarray(left), jnp.asarray(right), n_bands=2,
                                           halo=16)
    with torch.no_grad():
        got = tspatial.spatial_shard_infer(port, torch.from_numpy(left), torch.from_numpy(right),
                                           n_bands=2, halo=16)
    assert set(got) == set(ref) == {"seg1", "seg2", "disp1", "disp2"}
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape and r.shape[:3] == (1, 64, 128), k
        assert np.abs(got[k].numpy() - r).max() <= 1e-3 * np.abs(r).max(), k


def test_show_results_writes_six_panels(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the card's machine
    rng = np.random.default_rng(6)
    b, h, w = 2, 16, 24
    left = rng.standard_normal((b, h, w, 3), dtype=np.float32)
    logits = rng.standard_normal((b, h, w, 5), dtype=np.float32)
    gt = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (b, h, w))]
    disp_pred, disp_gt = (rng.random((b, h, w, 1), dtype=np.float32) * 50 for _ in range(2))
    tviz.show_results(str(tmp_path / "out"), "val", left, logits, gt, disp_pred, disp_gt)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["val_0.png", "val_1.png"]
    g = tviz.GAP
    for i in range(b):
        grid = png.read(str(tmp_path / "out" / f"val_{i}.png"))[..., ::-1]  # BGR -> RGB
        assert grid.shape == (2 * h + g, 3 * w + 2 * g, 3)
        panel = [grid[r * (h + g):r * (h + g) + h, c * (w + g):c * (w + g) + w]
                 for r in range(2) for c in range(3)]
        np.testing.assert_array_equal(panel[1], decode_segmap(gt[i].argmax(-1)))
        np.testing.assert_array_equal(panel[2], decode_segmap(logits[i].argmax(-1)))
        np.testing.assert_array_equal(panel[3], tviz.colorize(disp_gt[i, ..., 0], "jet"))
        np.testing.assert_array_equal(panel[4], tviz.colorize(disp_pred[i, ..., 0], "jet"))
        err = np.abs(disp_pred[i, ..., 0] - disp_gt[i, ..., 0])
        np.testing.assert_array_equal(panel[5], tviz.colorize(err, "magma"))
        img = left[i].astype(np.float64)
        assert np.abs(panel[0] - 255 * (img - img.min()) / (img.max() - img.min())).max() <= 0.5 + 1e-9
    # the ends of each colour map: jet's dark blue and dark red, magma's black
    ramp = np.linspace(0, 1, 5)[None]
    assert tviz.colorize(ramp, "jet")[0, [0, -1]].tolist() == [[0, 0, 128], [128, 0, 0]]
    assert tviz.colorize(ramp, "magma")[0, 0].tolist() == [0, 0, 4]


@pytest.mark.parametrize("cmap,tol", [("jet", 0.5), ("Blues", 0.5), ("magma", 3.0)])
def test_colorize_matches_matplotlib(cmap, tol):
    import matplotlib
    from matplotlib.colors import Normalize

    rng = np.random.default_rng(7)
    levels = np.concatenate([[0, 255], rng.permutation(256)]).reshape(2, 129)
    values = 2.0 + 7.3 * levels / 255.0  # each panel's minimum and maximum are levels 0 and 255
    want = 255.0 * matplotlib.colormaps[cmap](Normalize()(values))[..., :3]
    got = tviz.colorize(values, cmap)
    assert got.dtype == np.uint8 and got.shape == values.shape + (3,)
    assert np.abs(got - want).max() <= tol + 1e-9
