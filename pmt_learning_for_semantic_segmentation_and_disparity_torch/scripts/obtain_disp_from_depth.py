#!/usr/bin/env python
"""EXR depth -> disparity png dataset preparation.

Re-design of scripts/obtainDispFromDepth.py: reads 1-channel depth EXRs
(depth0*_L.exr / _R.exr per scene folder), converts with

    disp = 0.3 * (35/32 * 752) / Z + 1e-5         (:26-28)

writes per-scene disp*.png (uint8 cv2.imwrite saturation — the intentional
clipping documented in SURVEY.md §2.2), plus the occlusion-aware left->right
translation (:63-70, vectorized: the reference nests python loops per pixel)
and optional pfm export.

EXR IO: OpenEXR if available, else cv2.IMREAD_UNCHANGED (requires an
OpenEXR-enabled cv2 build).

The PyTorch port's copy of the repository's ``scripts/obtain_disp_from_depth.py``:
the same conversion and files, with ``write_pfm`` from the port's
``data/imageio.py`` in place of the JAX package's. It imports neither JAX
nor the JAX package:

    python pmt_learning_for_semantic_segmentation_and_disparity_torch/scripts/obtain_disp_from_depth.py ROOT [--pfm]
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

# the repository root, which holds the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

FOCAL = (35.0 / 32.0) * 752.0
BASELINE = 0.3


def depth_to_disp(z: np.ndarray) -> np.ndarray:
    return BASELINE * FOCAL / z + 1e-5


def read_exr_depth(path: str) -> np.ndarray:
    try:
        import OpenEXR, Imath, array  # noqa

        f = OpenEXR.InputFile(path)
        dw = f.header()["dataWindow"]
        w, h = dw.max.x - dw.min.x + 1, dw.max.y - dw.min.y + 1
        pt = Imath.PixelType(Imath.PixelType.FLOAT)
        data = np.frombuffer(f.channel("R", pt), np.float32).reshape(h, w)
        return data.copy()
    except ImportError:
        import cv2

        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise RuntimeError(f"cannot read {path} (no OpenEXR / exr-cv2)")
        return img[..., 0] if img.ndim == 3 else img


def translate_left_to_right(disp: np.ndarray, depth: np.ndarray,
                            max_depth: float = 6.0) -> np.ndarray:
    """Occlusion-aware reprojection (obtainDispFromDepth.py:63-70),
    vectorized: scatter depth into x + disp, nearer pixels win."""
    h, w = disp.shape
    out = np.zeros_like(depth)
    cols = np.arange(w)[None, :] + disp.astype(np.uint8)
    valid = (cols < w) & (depth < max_depth)
    rows = np.broadcast_to(np.arange(h)[:, None], disp.shape)
    # scatter farthest-first so nearest (smallest depth) lands last
    order = np.argsort(-depth, axis=None)
    r = rows.ravel()[order]
    c = cols.ravel()[order]
    v = valid.ravel()[order]
    out[r[v], np.minimum(c[v], w - 1)] = depth.ravel()[order][v]
    return out


def main():
    import cv2

    p = argparse.ArgumentParser()
    p.add_argument("root", help="dataset root with scene folders")
    p.add_argument("--scenes", default="*", help="scene glob")
    p.add_argument("--pfm", action="store_true", help="also write pfm")
    args = p.parse_args()

    from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import (
        imageio as pio,
    )

    scenes = sorted(glob.glob(os.path.join(args.root, args.scenes)))
    for scene in scenes:
        for side in ("L", "R"):
            for exr in sorted(glob.glob(os.path.join(scene, f"depth0*_{side}.exr"))):
                depth = read_exr_depth(exr)
                disp = depth_to_disp(depth)
                base = os.path.basename(exr).replace("depth", "disp").replace(
                    ".exr", ".png"
                )
                cv2.imwrite(os.path.join(scene, base), disp)  # uint8 saturate
                if args.pfm:
                    pio.write_pfm(
                        os.path.join(scene, base.replace(".png", ".pfm")),
                        disp.astype(np.float32),
                    )
        print(f"done {scene}")


if __name__ == "__main__":
    main()
