"""Synthetic ROSeS-style fixture generator: the port's copy of the JAX
package's ``make_roses_fixture`` (the same files for the same seed, written
by the port's PNG codec, which filters every row Sub as cv2's writer does).

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
