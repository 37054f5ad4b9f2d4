"""The port's data path against the JAX package's (and cv2, which the JAX
package reads and writes PNGs with and resizes with).

* The port's own fixture writer makes the files the JAX package's makes:
  every file decodes to the same array, exactly.
* The port's PNG codec (``data/png.py``): files it writes with each of the
  five row filters decode in cv2 to the array written, and it decodes them
  and cv2-written files to cv2's arrays, exactly.
* The port's resize against ``cv2.resize`` at the roses scales (1.00-1.20):
  INTER_NEAREST exactly; INTER_AREA on uint8 within 1 grey level (cv2's
  scalar and vector code round apart; the port follows the vector code and
  measures 0 here), on float32 within 1e-3 grey levels; and two shrinks
  (0.5, 0.9), nearest exactly and uint8 area within 1 grey level.
* The port's ``DataLoader`` batches against the JAX ``DataLoader``'s on the
  same fixture: two training epochs with the whole augmentation (rescale,
  crop, colour jitter) and the eval loader (``pad_to_bucket``, ``pad_mask``,
  a padded tail, ``valid``), with the native decoder on and off. Every key
  is bit-equal, except ``left``/``right`` of a sample that took the rescale,
  which may differ by 1 grey level (1/255 after normalisation).
* The cityscapes layout (``make_cityscapes_fixture``: 6 training and 3 test
  samples of 96x160, raw labelIds with ignore ids, x256 uint16 disparity,
  the class-occurrence CSV): the port's files decode in cv2 to the JAX
  fixture's arrays and the CSV text is identical; both packages' loaders
  with ``dataset_name="cityscapes"`` and the CSV's class balancer agree on
  every key over two training epochs and the padded eval loader, native
  decoder on and off, ``left``/``right`` within 1/255 (the rescale's
  rounding, which the balancer's draws make hard to attribute to a row).
  The port's loader runs on its 2 threads and the JAX loader's training
  batches at one worker: the port draws from the balancer in sample order,
  the JAX loader on its threads. With each chunk's first sample forced to
  finish last, the port's batches equal its one-thread batches bit for bit.
* ``utils/analysis.py`` over the port's datasets against the JAX package's
  over its own, on both fixtures: mean/std and disparity statistics in
  float64 exactly, the class-occurrence matrix and CSV text identical.
"""
import concurrent.futures as futures
import dataclasses
import os
import threading
import types

import cv2
import numpy as np
import pytest

from pmt_learning_for_semantic_segmentation_and_disparity_torch import data as TD
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import augment, png
from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import pipeline as tpipeline
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import analysis as tanalysis
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import data as JD
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import analysis as janalysis

FIXTURE_HW = (72, 136)
CITY_HW = (96, 160)
KINDS = ("left", "right", "disp", "seg", "inst", "left_t", "right_t", "disp_t", "seg_t", "inst_t")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    kw = dict(n_train=4, n_test=3, hw=FIXTURE_HW, seed=3)
    return (TD.make_roses_fixture(str(root / "port"), **kw),
            JD.make_roses_fixture(str(root / "jax"), **kw))


def test_fixture_decodes_like_jax(fixtures):
    port, jax_ = fixtures
    for kind in KINDS:
        ours, theirs = TD.read_manifest(port[kind]), JD.read_manifest(jax_[kind])
        assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
        for a, b in zip(ours, theirs):
            ref = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(png.read(a, unchanged=True), ref)
            np.testing.assert_array_equal(png.read(b, unchanged=True), ref)
            np.testing.assert_array_equal(png.read(a), cv2.imread(b))


@pytest.fixture(scope="module")
def city_fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("city")
    kw = dict(n_train=6, n_test=3, hw=CITY_HW, seed=4)
    return (TD.make_cityscapes_fixture(str(root / "port"), **kw),
            JD.make_cityscapes_fixture(str(root / "jax"), **kw))


def test_cityscapes_fixture_decodes_like_jax(city_fixtures):
    port, jax_ = city_fixtures
    for kind in KINDS:
        ours, theirs = TD.read_manifest(port[kind]), JD.read_manifest(jax_[kind])
        assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
        for a, b in zip(ours, theirs):
            ref = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            got = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            assert got.dtype == ref.dtype == (np.uint16 if "disp" in kind else np.uint8)
            np.testing.assert_array_equal(got, ref)
    with open(port["csv"]) as f, open(jax_["csv"]) as g:
        assert f.read() == g.read()


IMAGES = {"rgb8": ((37, 53, 3), np.uint8), "gray8": ((37, 53), np.uint8),
          "gray16": ((20, 31), np.uint16), "bgra8": ((11, 9, 4), np.uint8),
          "rgb16": ((16, 17, 3), np.uint16)}


@pytest.mark.parametrize("kind", sorted(IMAGES))
@pytest.mark.parametrize("filt", png.FILTERS)
def test_png_codec_against_cv2(tmp_path, kind, filt):
    shape, dtype = IMAGES[kind]
    rng = np.random.default_rng(len(kind) + png.FILTERS.index(filt))
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[3:7] = 7  # flat rows
    path = str(tmp_path / "x.png")
    png.write(path, img, filter=filt)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read(path, unchanged=True), img)
    np.testing.assert_array_equal(png.read(path), cv2.imread(path))
    cv_path = str(tmp_path / "cv.png")
    cv2.imwrite(cv_path, img)
    np.testing.assert_array_equal(png.read(cv_path, unchanged=True), cv2.imread(cv_path, -1))
    np.testing.assert_array_equal(png.read(cv_path), cv2.imread(cv_path))


ROSES_SCALES = (1.0, 1.01, 1.05, 1.07, 1.13, 1.17, 1.2)
SHRINKS = (0.5, 0.9)  # kitti's lower scales (0.90-1.5): INTER_AREA averages the covered area


@pytest.mark.parametrize("scale", ROSES_SCALES + SHRINKS)
def test_resize_against_cv2(scale):
    rng = np.random.default_rng(int(scale * 100))
    for h, w in ((72, 136), (57, 119)):
        dim = (round(w * scale), round(h * scale))
        for shape in ((h, w), (h, w, 2)):  # disparity/edges, seg
            f = rng.random(shape).astype(np.float32)
            np.testing.assert_array_equal(augment.resize_nearest(f, dim),
                                          cv2.resize(f, dim, interpolation=cv2.INTER_NEAREST))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        got = augment.resize_area(img, dim).astype(int)
        ref = cv2.resize(img, dim, interpolation=cv2.INTER_AREA).astype(int)
        assert got.shape == ref.shape and np.abs(got - ref).max() <= 1
        if scale >= 1:
            f = img.astype(np.float32)
            np.testing.assert_allclose(augment.resize_area(f, dim),
                                       cv2.resize(f, dim, interpolation=cv2.INTER_AREA), rtol=0, atol=1e-3)


def _datasets(package, manifests, native_io, crop=(48, 96), dataset="roses"):
    cfg = (PMTConfig if package is TD else JaxConfig)()
    package.apply_fixture_to_config(cfg, manifests)
    cfg.data.crop = crop
    if dataset != "roses":
        cfg.data.dataset_name = dataset
        cfg.data.class_balance_csv = manifests["csv"]
    norm = package.normalization_for(cfg.model.backbone, cfg.model.net)
    train, test = package.build_datasets(cfg.data, "linear", 1.0, norm)
    return tuple(dataclasses.replace(d, native_io=native_io) for d in (train, test))


def _batches(package, dataset, epochs, num_workers=2, **loader):
    dl = package.DataLoader(dataset, 2, num_workers=num_workers, seed=5, **loader)
    out = []
    for epoch in range(epochs):
        dl.set_epoch(epoch)
        out += list(dl)
    return out


def _rescaled(epoch, idx):
    """Whether sample ``idx`` took the rescale branch in ``epoch`` (the first
    draw of its generator, seeded as ``StereoSegDataset`` seeds it with the
    loader's seed 5 + epoch)."""
    rng = np.random.default_rng(((5 + epoch) * 1_000_003 + idx) & 0x7FFFFFFF)
    return rng.random() < 0.8


@pytest.mark.parametrize("native_io", ["on", "off"])
def test_loader_batches_match_jax(fixtures, native_io):
    port_m, jax_m = fixtures
    (ptrain, ptest), (jtrain, jtest) = (_datasets(TD, port_m, native_io),
                                        _datasets(JD, jax_m, native_io))
    assert (ptrain._native is None) == (native_io == "off") == (jtrain._native is None)
    seen_rescale = 0
    for n, (a, b) in enumerate(zip(_batches(TD, ptrain, 2), _batches(JD, jtrain, 2))):
        assert sorted(a) == sorted(b)
        epoch, part = divmod(n, 2)  # 4 samples, 2 batches an epoch
        rows = np.random.default_rng(5 + epoch).permutation(4)[2 * part:2 * part + 2]
        for k in a:
            if k == "meta":
                assert [[os.path.basename(p) for p in m] for m in a[k]] == \
                       [[os.path.basename(p) for p in m] for m in b[k]]
            elif k in ("left", "right"):
                for row, i in enumerate(rows):
                    d = np.abs(a[k][row] - b[k][row]).max()
                    if _rescaled(epoch, i):
                        seen_rescale += 1
                        assert d <= 1 / 255 + 1e-6, (k, n, row, d)
                    else:
                        assert d == 0, (k, n, row, d)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert seen_rescale  # the rescale branch was taken
    bucket = (80, 144)
    evals = [_batches(pkg, ds, 1, shuffle=False, drop_last=False, bucket_hw=bucket, pad_batch=True)
             for pkg, ds in ((TD, ptest), (JD, jtest))]
    assert [b["valid"] for b in evals[0]] == [b["valid"] for b in evals[1]] == [2, 1]
    for a, b in zip(*evals):
        assert sorted(a) == sorted(b)
        assert a["pad_mask"].shape == (2,) + bucket + (1,)
        for k in a:
            if k not in ("meta", "valid"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("native_io", ["on", "off"])
def test_cityscapes_loader_batches_match_jax(city_fixtures, native_io):
    port_m, jax_m = city_fixtures
    (ptrain, ptest), (jtrain, jtest) = (_datasets(pkg, m, native_io, dataset="cityscapes")
                                        for pkg, m in ((TD, port_m), (JD, jax_m)))
    assert (ptrain._native is None) == (native_io == "off") == (jtrain._native is None)
    assert ptrain._balancer is not None and jtrain._balancer is not None
    # the reference at one worker: the JAX loader draws from the balancer on
    # its threads, so at two its batches follow their timing (ROADMAP.md
    # queue 3 item 4); the port's draws are made in sample order
    train = list(zip(_batches(TD, ptrain, 2), _batches(JD, jtrain, 2, num_workers=1)))
    assert len(train) == 6  # 3 batches of 2 an epoch
    for a, b in train:
        assert sorted(a) == sorted(b)
        assert a["seg"].shape[-1] == 20  # 19 classes and the ignore channel
        for k in a:
            if k == "meta":
                assert [[os.path.basename(p) for p in m] for m in a[k]] == \
                       [[os.path.basename(p) for p in m] for m in b[k]]
            elif k in ("left", "right"):
                assert np.abs(a[k] - b[k]).max() <= 1 / 255 + 1e-6, k
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bucket = (112, 176)
    evals = [_batches(pkg, ds, 1, shuffle=False, drop_last=False, bucket_hw=bucket, pad_batch=True)
             for pkg, ds in ((TD, ptest), (JD, jtest))]
    assert [b["valid"] for b in evals[0]] == [b["valid"] for b in evals[1]] == [2, 1]
    for a, b in zip(*evals):
        assert sorted(a) == sorted(b)
        for k in a:
            if k not in ("meta", "valid"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _LateFirstPool(futures.ThreadPoolExecutor):
    """A pool whose first task of each ``map`` starts only once its second
    has finished, so a chunk's samples finish in the opposite order;
    ``finished`` records each task's place in its chunk as it ends."""

    finished = []

    def map(self, fn, items):
        second = threading.Event()

        def task(k, item):
            if k == 0:
                assert second.wait(60), "the second sample never finished"
            try:
                return fn(item)
            finally:
                self.finished.append(k)
                if k == 1:
                    second.set()

        tasks = [self.submit(task, k, item) for k, item in enumerate(items)]
        return [t.result() for t in tasks]


def test_cityscapes_loader_draws_in_sample_order(city_fixtures, monkeypatch):
    """The port's loader on its 2 threads with each chunk's first sample held
    back until the second's decode is done gives the batches of a run on one
    thread, bit for bit: the class balancer's draws do not follow the
    threads."""
    port_m, _ = city_fixtures
    serial = _batches(TD, _datasets(TD, port_m, "off", dataset="cityscapes")[0], 2, num_workers=1)
    monkeypatch.setattr(tpipeline, "futures", types.SimpleNamespace(ThreadPoolExecutor=_LateFirstPool))
    _LateFirstPool.finished = []
    late = _batches(TD, _datasets(TD, port_m, "off", dataset="cityscapes")[0], 2)
    assert _LateFirstPool.finished == [1, 0] * 6  # 3 chunks of 2 an epoch, 2 epochs
    assert len(late) == len(serial) == 6
    for a, b in zip(late, serial):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "meta":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dataset", ["roses", "cityscapes"])
def test_analysis_matches_jax(fixtures, city_fixtures, dataset, tmp_path):
    (port_m, jax_m), n = (fixtures, 2) if dataset == "roses" else (city_fixtures, 19)
    ptrain, _ = _datasets(TD, port_m, "off", dataset=dataset)
    jtrain, _ = _datasets(JD, jax_m, "off", dataset=dataset)
    for name in ("compute_mean_std", "compute_disp_stats"):
        got, ref = getattr(tanalysis, name)(ptrain), getattr(janalysis, name)(jtrain)
        assert set(got) == set(ref)
        for k in ref:
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, (name, k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} {k}")
    np.testing.assert_array_equal(tanalysis.count_classes_in_dataset(ptrain, n, workers=2),
                                  janalysis.count_classes_in_dataset(jtrain, n, workers=2))
    paths = [str(tmp_path / f"{who}.csv") for who in ("port", "jax")]
    tanalysis.class_occurrence_csv(ptrain, n, paths[0], workers=2)
    janalysis.class_occurrence_csv(jtrain, n, paths[1], workers=2)
    with open(paths[0]) as f, open(paths[1]) as g:
        assert f.read() == g.read()
    assert tanalysis.check_disparity_inversion(ptrain) is janalysis.check_disparity_inversion(jtrain) is True
