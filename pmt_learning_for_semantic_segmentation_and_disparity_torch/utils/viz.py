"""Result visualization without matplotlib: the showResults / plotBatchData
equivalents (util/utilTorchPlot.py:18, :216) and the confusion-matrix
heatmap (:358), as numpy colour maps written by the port's PNG codec
(``data/png.py``). The JAX package draws the same panels with matplotlib
(``utils/viz.py``), which the card's machine does not have; here each panel
is the colour-mapped array itself, without titles, ticks or colour bars.

``colorize`` maps values to RGB with matplotlib's ``jet``, ``magma`` and
``Blues``, linearly interpolated between knots: jet's and Blues' are the
maps' own segment data (so they equal matplotlib's to the rounding),
magma's are 17 evenly spaced samples of its 256 colours (within 3 of 255
of them). Each panel is scaled from its own minimum to its maximum as
``imshow`` scales it.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..data import png
from ..data.labels import decode_segmap

# per map: the (positions, values) of each of R, G, B in [0, 1]
_COLORMAPS = {
    "jet": (((0.0, 0.35, 0.66, 0.89, 1.0), (0.0, 0.0, 1.0, 1.0, 0.5)),
            ((0.0, 0.125, 0.375, 0.64, 0.91, 1.0), (0.0, 0.0, 1.0, 1.0, 0.0, 0.0)),
            ((0.0, 0.11, 0.34, 0.65, 1.0), (0.5, 1.0, 1.0, 0.0, 0.0))),
    "magma": tuple((np.linspace(0.0, 1.0, 17), np.array(c) / 255.0) for c in zip(
        (0, 0, 4), (10, 8, 34), (29, 17, 71), (54, 16, 107), (81, 18, 124), (106, 28, 129),
        (131, 38, 129), (156, 46, 127), (183, 55, 121), (208, 65, 111), (231, 82, 99),
        (245, 107, 92), (252, 137, 97), (254, 167, 114), (254, 196, 136), (253, 226, 163),
        (252, 253, 191))),
    "Blues": tuple((np.linspace(0.0, 1.0, 9), np.array(c) / 255.0) for c in zip(
        (247, 251, 255), (222, 235, 247), (198, 219, 239), (158, 202, 225), (107, 174, 214),
        (66, 146, 198), (33, 113, 181), (8, 81, 156), (8, 48, 107))),
}
# pixels between two panels of a sample's grid, and their grey level
GAP, GAP_LEVEL = 4, 255
# a confusion-matrix cell is drawn as a square of this many pixels a side
CELL = 32


def colorize(values: np.ndarray, cmap: str) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 RGB through colour map ``cmap``,
    scaled from the finite values' minimum to their maximum; a constant map
    takes the colour of 0, a non-finite value white."""
    x = np.asarray(values, np.float64)
    finite = np.isfinite(x)
    lo = x[finite].min() if finite.any() else 0.0
    hi = x[finite].max() if finite.any() else 0.0
    t = np.clip((np.where(finite, x, lo) - lo) / (hi - lo), 0.0, 1.0) if hi > lo else np.zeros_like(x)
    rgb = np.stack([np.interp(t, pos, val) for pos, val in _COLORMAPS[cmap]], axis=-1)
    rgb = np.where(finite[..., None], rgb, 1.0)
    return np.round(rgb * 255.0).astype(np.uint8)


def write_rgb(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB image as a PNG (the codec takes BGR, as cv2)."""
    png.write(path, np.ascontiguousarray(rgb[..., ::-1]))


def panel_grid(panels: Sequence[np.ndarray], cols: int) -> np.ndarray:
    """Equal-sized (H, W, 3) uint8 panels in a row-major grid of ``cols``
    columns, ``GAP`` pixels of ``GAP_LEVEL`` between them: panel k sits at
    rows (k // cols) * (H + GAP), columns (k % cols) * (W + GAP)."""
    h, w = panels[0].shape[:2]
    rows = -(-len(panels) // cols)
    grid = np.full((rows * (h + GAP) - GAP, cols * (w + GAP) - GAP, 3), GAP_LEVEL, np.uint8)
    for k, p in enumerate(panels):
        r, c = divmod(k, cols)
        grid[r * (h + GAP):r * (h + GAP) + h, c * (w + GAP):c * (w + GAP) + w] = p
    return grid


def show_results(
    out_dir: str,
    tag: str,
    left: np.ndarray,
    seg_pred_logits: np.ndarray,
    seg_gt_onehot: np.ndarray,
    disp_pred: np.ndarray,
    disp_gt: np.ndarray,
):
    """One PNG a sample, ``{tag}_{i}.png`` in ``out_dir``: the panels image /
    GT seg / pred seg over GT disp / pred disp / |disp error| in a 2 x 3
    grid (``panel_grid``). The image is scaled from its minimum to its
    maximum, the seg maps are ``decode_segmap`` of the argmax, the disparity
    panels ``jet`` and the error ``magma``. NHWC numpy batches."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(left.shape[0]):
        img = left[i].astype(np.float64)
        img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
        gt, pred = disp_gt[i, ..., 0], disp_pred[i, ..., 0]
        panels = [np.round(img * 255.0).astype(np.uint8),
                  decode_segmap(seg_gt_onehot[i].argmax(-1)),
                  decode_segmap(seg_pred_logits[i].argmax(-1)),
                  colorize(gt, "jet"), colorize(pred, "jet"),
                  colorize(np.abs(pred - gt), "magma")]
        write_rgb(os.path.join(out_dir, f"{tag}_{i}.png"), panel_grid(panels, cols=3))


def confusion_heatmap(cm: np.ndarray) -> np.ndarray:
    """A (normalised) confusion matrix as an RGB image: ``Blues`` over its
    finite range, a ``CELL``-pixel square per cell, row = true class,
    column = predicted class; an empty row's NaNs white."""
    return np.repeat(np.repeat(colorize(cm, "Blues"), CELL, axis=0), CELL, axis=1)
