"""Synthetic fixture generators: the port's copies of the JAX package's
``make_roses_fixture`` and ``make_cityscapes_fixture`` (the same files for
the same seed, written by the port's PNG codec, which filters every row Sub
as cv2's writer does and writes the x256 disparity as 16-bit gray).

The reference ships scripts/reduceExistentDataset.py to cut tiny manifest
subsets "to realize tests with less computation requirements" (README.md:37).
Without the real ROSeS data present, this module synthesizes a miniature
dataset with the same on-disk layout (left/right pngs, depth-encoded
'disparity' pngs, blue-channel seg masks, instance pngs + txt manifests) so
the full pipeline — IO, depth->disp math, one-hot, augment, training — runs
end-to-end anywhere.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from . import png


def make_roses_fixture(
    root: str, n_train: int = 4, n_test: int = 2, hw: Tuple[int, int] = (320, 560),
    seed: int = 0,
) -> dict:
    """Create a tiny ROSeS-like dataset; returns manifest paths."""
    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(root, exist_ok=True)
    names = {
        k: []
        for k in ("left", "right", "disp", "seg", "inst",
                  "left_t", "right_t", "disp_t", "seg_t", "inst_t")
    }

    def synth(i):
        # piecewise scene: random blobs of 'branch' over background. The
        # blobs are BRIGHT in the image (learnable signal, not independent
        # noise) so training on the fixture can actually converge.
        mask = np.zeros((h, w), np.uint8)
        for _ in range(4):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = int(rng.integers(10, 60))
            yy, xx = np.ogrid[:h, :w]
            mask |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8)
        left = rng.integers(0, 100, (h, w, 3)).astype(np.uint8)
        left[mask > 0] = 155 + left[mask > 0]  # bright branch pixels
        # depth png like scripts/obtainDispFromDepth.py writes: uint8 depth;
        # branches nearer (learnable depth cue)
        depth = np.where(mask > 0, rng.integers(10, 40, (h, w)),
                         rng.integers(120, 200, (h, w))).astype(np.uint8)
        # seg: blue channel > 128 => branch
        seg = np.zeros((h, w, 3), np.uint8)
        seg[..., 0] = mask * 200  # BGR on disk: blue channel
        inst = (mask * rng.integers(1, 5)).astype(np.uint8)
        # right = left shifted by a couple px (cheap stereo-ish)
        right = np.roll(left, 2, axis=1)
        return left, right, depth, seg, inst

    for split, n, suffix in (("train", n_train, ""), ("test", n_test, "_t")):
        for i in range(n):
            left, right, depth, seg, inst = synth(i)
            paths = {}
            for kind, arr in (
                ("left", left), ("right", right), ("disp", depth),
                ("seg", seg), ("inst", inst),
            ):
                p = os.path.join(root, f"{split}_{kind}_{i}.png")
                png.write(p, arr)
                paths[kind] = os.path.basename(p)
            for kind in ("left", "right", "disp", "seg", "inst"):
                names[kind + suffix].append(paths[kind])

    manifests = {}
    mapping = {
        "left": "colorL.txt", "right": "colorR.txt", "disp": "disp.txt",
        "seg": "seg.txt", "inst": "inst.txt",
        "left_t": "colorL_test.txt", "right_t": "colorR_test.txt",
        "disp_t": "disp_test.txt", "seg_t": "seg_test.txt",
        "inst_t": "inst_test.txt",
    }
    for key, fname in mapping.items():
        p = os.path.join(root, fname)
        with open(p, "w") as f:
            f.write("\n".join(names[key]) + "\n")
        manifests[key] = p
    return manifests


def make_cityscapes_fixture(
    root: str, n_train: int = 8, n_test: int = 2,
    hw: Tuple[int, int] = (96, 160), seed: int = 0,
) -> dict:
    """Cityscapes-layout miniature: raw labelId segmentation pngs (ignore
    ids included — the LUT's 255->extra-channel path, utilCityscape.py:
    173-186), uint16 disparity pngs on the x256 scale
    (utilTorchDataLoader.py:181-184), and a per-image class-occurrence CSV
    for the ClassBalancer (utilTorchDataLoader.py:60-125). Returns manifest
    paths plus ``csv``."""
    from .labels import _ID2TRAIN

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(root, exist_ok=True)
    names = {
        k: []
        for k in ("left", "right", "disp", "seg", "inst",
                  "left_t", "right_t", "disp_t", "seg_t", "inst_t")
    }
    # raw cityscapes ids covering every balanced trainId (3,4,5,6,7,9,11,
    # 12,14,15,16,17,18) plus ignore regions (id 0) and common classes
    raw_ids = np.array([0, 7, 12, 13, 17, 19, 20, 22, 24, 25, 27, 28, 31,
                        32, 33], np.uint8)
    per_image_classes = []

    for split, n, suffix in (("train", n_train, ""), ("test", n_test, "_t")):
        for i in range(n):
            left = rng.integers(0, 255, (h, w, 3), np.uint8)
            right = np.roll(left, 3, axis=1)
            # blocky labelId map: every image contains every raw id so each
            # balance-class column has candidates
            seg = np.repeat(
                raw_ids[rng.permutation(len(raw_ids))],
                h * w // len(raw_ids) + 1,
            )[: h * w].reshape(h, w)
            disp16 = (rng.random((h, w)) * 64 * 256).astype(np.uint16)
            inst = (seg % 7).astype(np.uint8)
            arrs = {"left": left, "right": right, "disp": disp16,
                    "seg": seg, "inst": inst}
            for kind, arr in arrs.items():
                p = os.path.join(root, f"cs_{split}_{kind}_{i}.png")
                png.write(p, arr)
                names[kind + suffix].append(os.path.basename(p))
            if split == "train":
                present = set(int(t) for t in _ID2TRAIN[seg].ravel()
                              if t != 255)
                per_image_classes.append(present)

    manifests = {}
    mapping = {
        "left": "colorL.txt", "right": "colorR.txt", "disp": "disp.txt",
        "seg": "seg.txt", "inst": "inst.txt",
        "left_t": "colorL_test.txt", "right_t": "colorR_test.txt",
        "disp_t": "disp_test.txt", "seg_t": "seg_test.txt",
        "inst_t": "inst_test.txt",
    }
    for key, fname in mapping.items():
        p = os.path.join(root, fname)
        with open(p, "w") as f:
            f.write("\n".join(names[key]) + "\n")
        manifests[key] = p

    # class-occurrence CSV: column "n" = dataset index, one 0/1 column per
    # trainId (the balancer reads str(cls) columns)
    csv_path = os.path.join(root, "class_balance.csv")
    cols = sorted({c for s in per_image_classes for c in s})
    with open(csv_path, "w") as f:
        f.write("n," + ",".join(str(c) for c in cols) + "\n")
        for i, present in enumerate(per_image_classes):
            f.write(str(i) + ","
                    + ",".join("1" if c in present else "0" for c in cols)
                    + "\n")
    manifests["csv"] = csv_path
    return manifests


def apply_fixture_to_config(cfg, manifests: dict):
    cfg.data.color_l = manifests["left"]
    cfg.data.color_r = manifests["right"]
    cfg.data.disp = manifests["disp"]
    cfg.data.seg = manifests["seg"]
    cfg.data.inst = manifests["inst"]
    cfg.data.color_l_test = manifests["left_t"]
    cfg.data.color_r_test = manifests["right_t"]
    cfg.data.disp_test = manifests["disp_t"]
    cfg.data.seg_test = manifests["seg_t"]
    cfg.data.inst_test = manifests["inst_t"]
    return cfg
