"""Host-side geometric + photometric augmentation: the port's copy of the
JAX package's ``data/augment.py``.

Numpy re-design of util/utilTorchDataLoader.py:348-605 (RandomCrop compound
transform) and :276-303 (joint L/R color jitter). Deterministic via an
explicit np.random.Generator instead of torch's global RNG.

The rescale of ``RandomCropAugment`` uses the port's own resize
(``resize_area``, ``resize_nearest``), never cv2, so every machine computes
the same batch. It is cv2.resize's: nearest exactly (cv2's source index
floor(x * src / dst)); INTER_AREA on an enlargement is cv2's area-weighted
linear interpolation, in cv2's fixed point for uint8 as its vector code
rounds it (cv2's scalar code, which it runs on a row's tail where the vector
width does not divide it, rounds some pixels one grey level apart), and a
shrink averages the covered source area.

Sample dict convention (HWC numpy): left, right (uint8/float RGB),
disp (H,W,1 float), seg (H,W,C one-hot float), edges (H,W,1 float).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage



def _area_up_taps(src: int, dst: int, clamp: bool):
    """cv2's INTER_AREA taps for an enlargement along one axis (resize.cpp:
    ``sx = floor(dx * scale)``, ``fx = (dx + 1) - (sx + 1) / scale`` wrapped
    into [0, 1), in float32): the two source indices (the second clamped
    into the image) and the two weights ``1 - fx`` and ``fx``. With
    ``clamp`` (the horizontal axis), a tap on the last sample has weight
    (1, 0), as cv2 sets it."""
    inv = dst / src
    scale = 1.0 / inv
    dx = np.arange(dst, dtype=np.float64)
    sx = np.floor(dx * scale).astype(np.int64)
    fx = ((dx + 1) - (sx + 1) * inv).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    if clamp:
        last = sx >= src - 1
        fx[last], sx[last] = 0, src - 1
    return sx, np.minimum(sx + 1, src - 1), np.float32(1) - fx, fx


def _area_down_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of an area shrink: the overlap of each output
    pixel's source interval [d * s, (d + 1) * s) with each source pixel,
    divided by s = src / dst."""
    s = src / dst
    edges = np.arange(dst + 1) * s
    lo, hi = edges[:-1, None], edges[1:, None]
    j = np.arange(src)[None, :]
    return np.clip(np.minimum(hi, j + 1) - np.maximum(lo, j), 0, None) / s


def resize_area(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_AREA) of an
    (H, W) or (H, W, C) uint8 or float32 image."""
    (dw, dh), (sh, sw) = dsize, img.shape[:2]
    if (dh, dw) == (sh, sw):
        return img.copy()
    if dh < sh or dw < sw:
        if dh > sh or dw > sw:
            raise NotImplementedError("INTER_AREA that shrinks one axis and enlarges the other")
        x = img.astype(np.float64)
        x = np.tensordot(_area_down_weights(sh, dh), x, axes=(1, 0))
        x = np.moveaxis(np.tensordot(_area_down_weights(sw, dw), x, axes=(1, 1)), 0, 1)
        if img.dtype == np.uint8:
            return np.clip(np.rint(x), 0, 255).astype(np.uint8)
        return x.astype(img.dtype)
    y0, y1, by0, by1 = _area_up_taps(sh, dh, clamp=False)
    x0, x1, bx0, bx1 = _area_up_taps(sw, dw, clamp=True)
    cols = (slice(None),) + (None,) * (img.ndim - 2)
    rows = (slice(None), None) + (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        # resize.cpp's fixed point: each weight rounded to 11 bits, columns
        # then rows, the rows as its vector code rounds them
        # (VResizeLinearVec_32s8u: (h >> 4) * w >> 16 a term, (sum + 2) >> 2)
        fixed = lambda w: np.rint(w * np.float32(2048)).astype(np.int32)  # noqa: E731
        s = img.astype(np.int32)  # every sum below fits in 27 bits
        h = (s[:, x0] * fixed(bx0)[cols] + s[:, x1] * fixed(bx1)[cols]) >> 4
        out = ((h[y0] * fixed(by0)[rows]) >> 16) + ((h[y1] * fixed(by1)[rows]) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    s = img.astype(np.float32)
    h = s[:, x0] * bx0[cols] + s[:, x1] * bx1[cols]
    return (h[y0] * by0[rows] + h[y1] * by1[rows]).astype(img.dtype)


def resize_nearest(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_NEAREST):
    output pixel x reads source pixel min(floor(x * (src / dst)), src - 1)."""
    (dw, dh), (sh, sw) = dsize, img.shape[:2]
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))).astype(np.int64), sw - 1)
    return img[ys][:, xs]


_BALANCE_CLASSES = {
    "cityscapes": np.array([3, 4, 5, 6, 7, 9, 11, 12, 14, 15, 16, 17, 18]),
    "kitti": np.array([3, 4, 5, 6, 7, 9, 11, 12, 14, 15, 16, 17, 18]),
    "garden": np.array([0, 2, 3, 4, 5, 6, 7]),
    "roses": np.array([0, 1]),
}

_SCALE_RANGES = {  # utilTorchDataLoader.py:409-421
    "kitti": (0.90, 1.5),
    "garden": (1.0, 1.2),
    "roses": (1.0, 1.2),
}


def _cityscapes_scale_range(
    crop_hw: Tuple[int, int], img_hw: Tuple[int, int]
) -> Tuple[float, float]:
    """utilTorchDataLoader.py:409-421 hardcodes 1024-tall sources
    (lower = crop_h/1024). Generalized to the actual image size so the
    scaled image always covers the crop in BOTH dims — identical to the
    reference on real 1024x2048 cityscapes with its 1:2 crops."""
    ch, cw = crop_hw
    h, w = img_hw
    upper = 1.2 if ch < 512 else 1.5
    lower = max(np.ceil(ch / h * 100), np.ceil(cw / w * 100)) / 100
    return (lower, max(upper, lower))


@dataclass
class RandomCropAugment:
    """The train-time compound transform (RandomCrop(..., focusPerson=True,
    resizeImg=True, flipHorizontal=True), utilTorchDataLoader.py:689-692)."""

    output_size: Tuple[int, int]
    dataset_name: str
    is_down: bool = False
    slice_and_switch: bool = False
    augment_double_left: bool = False
    focus_person: bool = False
    resize_img: bool = False
    flip_horizontal: bool = False

    def __post_init__(self):
        n = {"cityscapes": 20, "kitti": 20, "garden": 10}.get(self.dataset_name)
        self.class_count = np.ones(n) if n else None
        self.balance_class = _BALANCE_CLASSES.get(self.dataset_name)

    def __call__(
        self, sample: Dict[str, np.ndarray], rng: np.random.Generator,
        class_indx: int = -1,
    ) -> Dict[str, np.ndarray]:
        imgs = [sample["left"], sample["right"], sample["disp"],
                sample["seg"], sample["edges"]]
        if self.output_size[0] == 0:  # crop [0,0] passthrough (test set)
            return sample

        if self.resize_img and rng.random() < 0.8:
            if self.dataset_name == "cityscapes":
                lower, upper = _cityscapes_scale_range(
                    self.output_size, imgs[0].shape[:2])
            else:
                lower, upper = _SCALE_RANGES[self.dataset_name]
            scale = round(float(rng.uniform(lower, upper)), 2)
            h, w = imgs[0].shape[:2]
            dim = (round(w * scale), round(h * scale))
            for i in range(len(imgs)):
                a = imgs[i]
                if a.ndim == 4:
                    a = np.squeeze(a, 3)
                # disparity VALUES scale with the image (idx 2)
                src = a * scale if i == 2 else a
                resize = resize_area if i < 2 else resize_nearest
                a = resize(src.astype(np.float32) if i >= 2 else src, dim)
                if a.ndim < 3:
                    a = a[..., None]
                imgs[i] = a

        h, w = imgs[0].shape[:2]
        new_h, new_w = self.output_size
        if self.is_down:  # deterministic bottom-center eval crop (:442-444)
            top = h - new_h
            left = (w - new_w) // 2
        else:
            y_start = (
                max(h - new_h - 100, 0)
                if (self.dataset_name == "kitti" and rng.random() < 0.8)
                else 0
            )
            left = top = -1
            if self.focus_person:
                left, top = self._crop_person(imgs[3], rng, class_indx)
            if left == -1:
                top = int(rng.integers(y_start, h - new_h + 1))
                left = int(rng.integers(0, w - new_w + 1))

        if self.slice_and_switch:
            div = int(h / float(rng.integers(2, 6)))

        for i in range(len(imgs)):
            imgs[i] = imgs[i][top : top + new_h, left : left + new_w]
            if self.slice_and_switch:
                imgs[i] = np.concatenate([imgs[i][div:], imgs[i][:div]], axis=0)

        if self.augment_double_left and rng.random() < 0.1:
            # degenerate-stereo augment (:471-476)
            imgs[0] = imgs[0][:, ::-1].copy()
            imgs[1] = imgs[0]
            imgs[2] = np.zeros_like(imgs[2]) + 1e-4
            imgs[3] = imgs[3][:, ::-1].copy()
            imgs[4] = imgs[4][:, ::-1].copy()

        if (
            self.flip_horizontal
            and rng.random() < 0.5
            and self.dataset_name == "cityscapes"
        ):
            imgs = self._stereo_flip(imgs)

        return {"left": imgs[0], "right": imgs[1], "disp": imgs[2],
                "seg": imgs[3], "edges": imgs[4]}

    # -- stereo-correct horizontal flip with disparity reprojection (:478-502)
    @staticmethod
    def _stereo_flip(imgs):
        left, right, disp, seg, edges = imgs
        tmp = left[:, ::-1].copy()
        left = right[:, ::-1].copy()
        right = tmp
        r = np.arange(disp.shape[0])
        c = np.arange(disp.shape[1])
        cv_, rv = np.meshgrid(c, r)
        cv_disp = (cv_ - disp[..., 0]).astype(np.int64)
        cv_disp[cv_disp < 0] = 0
        disp[rv.ravel(), cv_disp.ravel(), :] = disp[rv.ravel(), cv_.ravel(), :]
        seg[rv.ravel(), cv_disp.ravel(), :] = seg[rv.ravel(), cv_.ravel(), :]
        disp[:, -10:] = 0
        seg[:, -20:, :] = 0
        occluded = (np.sum(disp, axis=2) == 0) * 1
        seg[:, :, -1] = occluded
        seg[:, :, :-1] *= 1 - occluded[:, :, None]
        disp = disp[:, ::-1, :].copy()
        seg = seg[:, ::-1, :].copy()
        return [left, right, disp, seg, edges]

    # -- class-focused crop via connected components (:533-605)
    def _crop_person(self, seg, rng: np.random.Generator, class_indx: int):
        if self.dataset_name not in ("kitti", "cityscapes", "garden"):
            return -1, -1
        h, w, _ = seg.shape
        count_class = np.any(seg, axis=(0, 1))
        current = np.where(count_class == 1)[0]
        class_idx = np.intersect1d(current, self.balance_class)
        if not len(class_idx) and class_indx == -1:
            return -1, -1
        if class_indx == -1:
            prob = 1.0 / self.class_count[class_idx]
            prob /= prob.sum()
            choice = class_idx[
                rng.choice(np.flatnonzero(prob == prob.max()))
            ]
        else:
            choice = class_indx
        # 8-connected components (skimage.measure.label equivalent)
        lbl, n = ndimage.label(seg[:, :, choice], structure=np.ones((3, 3)))
        if n == 0:
            return -1, -1
        pick = rng.choice(np.arange(n) + 1)
        idx = np.argwhere(lbl == pick)
        r_min, c_min = idx.min(axis=0)
        r_max, c_max = idx.max(axis=0)
        sy = int(rng.integers(min(r_max - self.output_size[0], r_min),
                              max(r_max - self.output_size[0], r_min) + 1))
        sx = int(rng.integers(min(c_max - self.output_size[1], c_min),
                              max(c_max - self.output_size[1], c_min) + 1))
        sy = int(max(min(sy, h - self.output_size[0]), 0))
        sx = int(max(min(sx, w - self.output_size[1]), 0))
        if class_indx == -1:
            cc = np.any(
                seg[sy : sy + self.output_size[0], sx : sx + self.output_size[1]],
                axis=(0, 1),
            )
            cur = np.where(cc == 1)[0]
            self.class_count[np.intersect1d(cur, self.balance_class)] += 1
        return sx, sy


def color_jitter_pair(
    left: np.ndarray, right: np.ndarray, rng: np.random.Generator,
    brightness: float = 0.5, contrast: float = 0.2, saturation: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Joint L/R photometric jitter (CustomDataset.adjust_brightess,
    utilTorchDataLoader.py:276-303): shared factors, then p=0.9 gaussian
    blur with sigma in [0.15, 1.3]. Operates on uint8 RGB."""
    lf = left.astype(np.float32)
    rf = right.astype(np.float32)

    b = float(rng.uniform(max(0, 1 - brightness), 1 + brightness))
    lf, rf = lf * b, rf * b

    c = float(rng.uniform(max(0, 1 - contrast), 1 + contrast))
    # torchvision adjust_contrast: blend with the mean of the grayscale image
    for img in (lf, rf):
        gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
        mean = gray.mean()
        img *= c
        img += (1 - c) * mean

    s = float(rng.uniform(max(0, 1 - saturation), 1 + saturation))
    for img in (lf, rf):
        gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
        img *= s
        img += (1 - s) * gray[..., None]

    if rng.random() < 0.9:
        sigma = 0.15 + float(rng.random()) * 1.15
        lf = ndimage.gaussian_filter(lf, sigma=(sigma, sigma, 0))
        rf = ndimage.gaussian_filter(rf, sigma=(sigma, sigma, 0))

    return (
        np.clip(lf, 0, 255).astype(np.uint8),
        np.clip(rf, 0, 255).astype(np.uint8),
    )
