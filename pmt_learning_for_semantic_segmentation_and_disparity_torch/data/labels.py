"""Label encodings: cityscapes id->trainId LUT, roses/garden one-hot rules
(a copy of the JAX package's ``data/labels.py``).

Mirror of util/utilCityscape.py:164-188 and the dataset branches in
util/utilTorchDataLoader.py:197-208. The cityscapes table is the standard
public labels table (Cityscapes scripts); only id/trainId/color are needed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# (name, id, trainId, color) — standard cityscapes label defs
CITYSCAPES_LABELS = [
    ("unlabeled", 0, 255, (0, 0, 0)),
    ("ego vehicle", 1, 255, (0, 0, 0)),
    ("rectification border", 2, 255, (0, 0, 0)),
    ("out of roi", 3, 255, (0, 0, 0)),
    ("static", 4, 255, (0, 0, 0)),
    ("dynamic", 5, 255, (111, 74, 0)),
    ("ground", 6, 255, (81, 0, 81)),
    ("road", 7, 0, (128, 64, 128)),
    ("sidewalk", 8, 1, (244, 35, 232)),
    ("parking", 9, 255, (250, 170, 160)),
    ("rail track", 10, 255, (230, 150, 140)),
    ("building", 11, 2, (70, 70, 70)),
    ("wall", 12, 3, (102, 102, 156)),
    ("fence", 13, 4, (190, 153, 153)),
    ("guard rail", 14, 255, (180, 165, 180)),
    ("bridge", 15, 255, (150, 100, 100)),
    ("tunnel", 16, 255, (150, 120, 90)),
    ("pole", 17, 5, (153, 153, 153)),
    ("polegroup", 18, 255, (153, 153, 153)),
    ("traffic light", 19, 6, (250, 170, 30)),
    ("traffic sign", 20, 7, (220, 220, 0)),
    ("vegetation", 21, 8, (107, 142, 35)),
    ("terrain", 22, 9, (152, 251, 152)),
    ("sky", 23, 10, (70, 130, 180)),
    ("person", 24, 11, (220, 20, 60)),
    ("rider", 25, 12, (255, 0, 0)),
    ("car", 26, 13, (0, 0, 142)),
    ("truck", 27, 14, (0, 0, 70)),
    ("bus", 28, 15, (0, 60, 100)),
    ("caravan", 29, 255, (0, 0, 90)),
    ("trailer", 30, 255, (0, 0, 110)),
    ("train", 31, 16, (0, 80, 100)),
    ("motorcycle", 32, 17, (0, 0, 230)),
    ("bicycle", 33, 18, (119, 11, 32)),
    ("license plate", -1, -1, (0, 0, 142)),
]

_ID2TRAIN = np.full(256, 255, np.int32)
for _, _id, _tid, _ in CITYSCAPES_LABELS:
    if 0 <= _id < 256:
        _ID2TRAIN[_id] = _tid


def img_id2train_id(ids: np.ndarray, labels: int = 19) -> np.ndarray:
    """ImgId2trainId (utilCityscape.py:173-186): one-hot (H,W,labels+1) with
    all ignore (trainId 255) ids accumulated into the extra last channel."""
    tid = _ID2TRAIN[ids.astype(np.int32)]
    seg = np.zeros((ids.shape[0], ids.shape[1], labels + 1), np.uint8)
    valid = tid != 255
    seg.reshape(-1, labels + 1)[
        np.arange(ids.size)[valid.ravel()], tid.ravel()[valid.ravel()]
    ] = 1
    seg[..., labels] = (~valid).astype(np.uint8)
    return seg


def roses_one_hot(seg_rgb: np.ndarray, n_labels: int = 2) -> np.ndarray:
    """roses binarization (utilTorchDataLoader.py:197-208): blue channel
    thresholded at 128 -> class 1, else class 0; one-hot (H,W,2)."""
    thr = 128
    seg_binary = np.zeros(seg_rgb.shape)
    seg_binary[seg_rgb > thr] = 1
    seg_binary = seg_binary[:, :, 2]
    out = np.zeros((seg_rgb.shape[0], seg_rgb.shape[1], n_labels), np.float32)
    for j in range(n_labels):
        out[:, :, j] = (seg_binary == j).astype(np.uint8)
    return out


def garden_one_hot(seg_ids: np.ndarray, n_labels: int = 9) -> np.ndarray:
    """garden: class j <- (seg == j+1) (utilTorchDataLoader.py:207-208)."""
    out = np.zeros((seg_ids.shape[0], seg_ids.shape[1], n_labels), np.float32)
    for j in range(n_labels):
        out[:, :, j] = (seg_ids == j + 1).astype(np.uint8)
    return out


def decode_segmap(label_mask: np.ndarray, n_classes: int = 21) -> np.ndarray:
    """21-color palette used by the result plots (utilTorchPlot.py:160)."""
    colors = np.array(
        [
            (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
            (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
            (107, 142, 35), (152, 251, 152), (0, 130, 180), (220, 20, 60),
            (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100),
            (0, 80, 100), (0, 0, 230), (119, 11, 32), (64, 0, 64),
            (0, 0, 0),
        ],
        np.uint8,
    )
    label_mask = np.clip(label_mask.astype(np.int32), 0, len(colors) - 1)
    return colors[label_mask]
