"""Dataset: per-sample loading with the reference's exact data math (the
port's copy of the JAX package's ``data/datasets.py``).

PNGs decode through the native library where ``native_io`` allows it and it
builds here (``data/native.py``), else through the port's own PNG codec
(``data/png.py``); both give the same arrays. Each dataset records the
decoder it chose in ``DECODERS``.

Numpy re-design of util/utilTorchDataLoader.py CustomDataset (:24-303):

* ROSeS/garden 'disparity' pngs hold DEPTH; the loader inverts them as
  disp = f*b/depth with f=640, b=0.03 (:57-58, :171-179). The png is read
  BGR 3-channel by the reference; we keep channel 0 (the channels are equal
  — the stored map is grayscale), which makes the regression target
  identical while keeping disp single-channel (SURVEY.md §2.2 gotcha).
* kitti/cityscapes disparity png / 256 (:181-184).
* activation-dependent normalization: clamp at max_d unless linear;
  sigmoid -> /max_d; tanh -> 2d/max_d - 1 (:186-195).
* one-hot rules per dataset (labels.py).
* instance map -> sobel binary edges (:152-155).
* optional hdf5 source, optional class-balanced resampling driven by a
  per-image class-occurrence CSV (:60-125).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import DataConfig, ROSES_BASELINE, ROSES_FOCAL
from ..ops.edges import sobel_edges
from . import imageio as io
from .augment import RandomCropAugment, color_jitter_pair
from .labels import garden_one_hot, img_id2train_id, roses_one_hot


# the decoder each dataset built in this process chose: "native" (the
# library built from native/pmt_dataio.cc) or "png" (data/png.py)
DECODERS: List[str] = []


def _rgb2gray(img: np.ndarray) -> np.ndarray:
    return (
        0.2125 * img[..., 0] + 0.7154 * img[..., 1] + 0.0721 * img[..., 2]
    ) / 255.0


@dataclass
class StereoSegDataset:
    """Index-addressable sample source; augmentation is injected."""

    x_files: Sequence[Tuple[str, str]]  # (colorL, colorR)
    y_files: Sequence[Tuple[str, str, str]]  # (disp, seg, inst)
    n_labels: int
    max_d: float
    dataset_name: str
    normalize: np.ndarray  # (2,3) mean/std
    output_activation: str = "sigmoid"
    only_test: bool = False
    transform: Optional[RandomCropAugment] = None
    color_jitter: bool = False
    hdf5: str = ""
    class_balance_csv: str = ""
    seed: int = 0
    # native C++ batch decoder (native/pmt_dataio.cc): PNG decode +
    # depth->disp + one-hot + sobel in one GIL-free call. "auto" uses it
    # for the png path whenever the library builds and loads here.
    native_io: str = "auto"  # "auto" | "on" | "off"

    def __post_init__(self):
        self._native = None
        if self.native_io != "off" and not self.hdf5 \
                and self.dataset_name in ("roses", "kitti", "kitti2015",
                                          "cityscapes"):
            from . import native as N

            if N.native_available():
                self._native = N
            elif self.native_io == "on":
                raise RuntimeError(
                    "native_io='on' but the native decoder is unavailable: "
                    f"{N.unavailable_reason()}")
        DECODERS.append("native" if self._native is not None else "png")
        self._file = None
        if self.hdf5:
            import h5py

            self._file = h5py.File(self.hdf5, "r")
        self._balancer = None
        if self.class_balance_csv:
            self._balancer = ClassBalancer(
                self.class_balance_csv, self.dataset_name, self.n_labels
            )

    def __len__(self) -> int:
        if self._file is not None:
            return len(self._file["left"])
        return len(self.x_files)

    def load_raw(self, idx: int) -> Dict[str, np.ndarray]:
        if self._file is not None:
            # hdf5 source (utilTorchDataLoader.py:139-144). Two reference
            # bugs fixed here: (a) the reference divides left/right by 255
            # at load AND again at normalize time (:140 vs :256), so its
            # hdf5 images were doubly scaled — we keep the 0-255 convention
            # of the file path and normalize exactly once in __getitem__;
            # (b) 'edges' is kept loading the 'disp' dataset, mirroring the
            # reference's (intentional-looking) reuse at :144.
            disp = self._file["disp"][idx].astype(np.float32)
            if disp.ndim == 2:
                disp = disp[..., None]
            return {
                "left": self._file["left"][idx].astype(np.float32),
                "right": self._file["right"][idx].astype(np.float32),
                "seg": self._file["seg"][idx].astype(np.float32),
                "disp": disp,
                "edges": disp.copy(),
            }
        disp_path, seg_path, inst_path = self.y_files[idx]
        lp, rp = self.x_files[idx]
        if self._native is not None and all(
            str(p).endswith(".png")
            for p in (lp, rp, disp_path, seg_path, inst_path)
        ):
            if self.dataset_name == "roses":
                return self._load_raw_native(lp, rp, disp_path, seg_path,
                                             inst_path)
            return self._load_raw_native_city(lp, rp, disp_path, seg_path,
                                              inst_path)
        left = io.read_rgb(lp)
        right = io.read_rgb(rp)
        # seg is read RGB like the reference's PIL load
        # (utilTorchDataLoader.py:150-151); roses thresholds the BLUE channel
        # (index 2 in RGB order, :204-205)
        if self.dataset_name in ("garden", "roses"):
            seg_raw = io.read_rgb(seg_path)
        else:
            seg_raw = np.asarray(io.read_image(seg_path))
        inst = np.asarray(io.read_image(inst_path))
        if inst.ndim == 3:
            inst = inst[..., 0]
        edges = sobel_edges(inst)[..., None].astype(np.float32)

        name = self.dataset_name
        if name in ("garden", "roses"):
            depth = io.read(disp_path)
            if depth.ndim == 3:
                depth = depth[..., 0]
            with np.errstate(invalid="ignore", divide="ignore"):
                disp = np.where(
                    depth > 0, ROSES_FOCAL * ROSES_BASELINE / depth, 0
                ).astype(np.float32)
            if name == "roses":
                if seg_raw.ndim == 2:
                    seg_raw = np.stack([seg_raw] * 3, -1)
                seg = roses_one_hot(seg_raw, self.n_labels)
            else:
                ids = seg_raw[..., 0] if seg_raw.ndim == 3 else seg_raw
                seg = garden_one_hot(ids, self.n_labels)
        else:  # kitti / cityscapes
            raw = io.read_image(disp_path)
            if raw.ndim == 3:
                raw = raw[..., 0]
            disp = raw.astype(np.float32) / 256.0
            seg = img_id2train_id(seg_raw, self.n_labels).astype(np.float32)

        if self.output_activation != "linear":
            disp = np.minimum(disp, self.max_d)
        if self.output_activation == "sigmoid":
            disp = disp / self.max_d
        elif self.output_activation == "tanh":
            disp = np.where(disp != 0, 2 * disp / float(self.max_d) - 1, -1)

        return {
            "left": left,
            "right": right,
            "seg": seg.astype(np.float32),
            "disp": disp[..., None].astype(np.float32),
            "edges": edges,
        }

    def _load_raw_native(self, lp, rp, dp, sp, ip) -> Dict[str, np.ndarray]:
        """Single-sample decode through the C++ runtime (the loader path the
        .cc was written for). Returns the numpy path's
        conventions exactly: left/right on the 0-255 scale (mean=0,
        std=1/255 inverts the native (x/255-m)/s), disp with the activation
        normalization already applied like load_raw."""
        N = self._native
        h, w, _ = N.png_info(lp)
        act = self.output_activation
        out = N.decode_roses_batch(
            [lp], [rp], [dp], [sp], [ip], hw=(h, w),
            n_labels=self.n_labels,
            activation="linear" if act == "relu" else act,
            max_d=float(self.max_d),
            mean=(0.0, 0.0, 0.0), std=(1.0 / 255.0,) * 3, n_threads=1,
        )
        sample = {k: v[0] for k, v in out.items()}
        if act == "relu":
            # relu clamps at max_d without rescaling (load_raw above)
            sample["disp"] = np.minimum(sample["disp"], self.max_d)
        return sample

    def _load_raw_native_city(self, lp, rp, dp, sp, ip) -> Dict[str, np.ndarray]:
        """kitti/cityscapes decode through the C++ runtime: uint16 disparity / 256,
        labelId -> trainId LUT one-hot incl. the ignore channel, instance
        sobel. Same conventions as _load_raw_native."""
        from .labels import _ID2TRAIN

        N = self._native
        h, w, _ = N.png_info(lp)
        act = self.output_activation
        out = N.decode_city_batch(
            [lp], [rp], [dp], [sp], [ip], hw=(h, w), lut=_ID2TRAIN,
            n_labels=self.n_labels,
            activation="linear" if act == "relu" else act,
            max_d=float(self.max_d),
            mean=(0.0, 0.0, 0.0), std=(1.0 / 255.0,) * 3, n_threads=1,
        )
        sample = {k: v[0] for k, v in out.items()}
        if act == "relu":
            sample["disp"] = np.minimum(sample["disp"], self.max_d)
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.load(*self.draw(idx))

    def draw(self, idx: int) -> Tuple[np.random.Generator, int, int]:
        """Sample ``idx``'s generator and what the class balancer draws with
        it: (rng, the index to load, the balanced class or -1). The
        balancer is stateful, so draws made in sample order give the
        batches of a serial ``__getitem__``; ``DataLoader`` makes them on
        its dispatching thread."""
        rng = np.random.default_rng((self.seed * 1_000_003 + idx) & 0x7FFFFFFF)
        class_indx = -1
        if self._balancer is not None:
            idx, class_indx = self._balancer.next_index(rng)
        return rng, idx, class_indx

    def load(self, rng: np.random.Generator, idx: int, class_indx: int) -> Dict[str, np.ndarray]:
        """The sample of a ``draw``: decode, augmentation, normalisation."""
        sample = self.load_raw(idx)
        if self.transform is not None:
            sample = self.transform(sample, rng, class_indx)
            if self.color_jitter and rng.random() < 0.9:
                sample["left"], sample["right"] = color_jitter_pair(
                    sample["left"], sample["right"], rng
                )
        mean, std = self.normalize[0], self.normalize[1]
        for k in ("left", "right"):
            sample[k] = ((sample[k] / 255.0 - mean) / std).astype(np.float32)
        if self.only_test:
            h, w = sample["left"].shape[:2]
            sample["seg"] = np.zeros((h, w, self.n_labels + 1), np.float32)
            sample["disp"] = np.zeros((h, w, 1), np.float32)
            sample["meta"] = (
                [self.hdf5] if self._file is not None
                else list(self.x_files[idx])
            )
        elif self._file is not None:
            # hdf5 metadata is the container path (utilTorchDataLoader.py:266-267)
            sample["meta"] = [self.hdf5]
        else:
            sample["meta"] = [self.y_files[idx][0], self.y_files[idx][1]]
        return sample


class ClassBalancer:
    """Least-sampled-class / least-sampled-image resampling
    (utilTorchDataLoader.py:60-125). Host-side stateful bookkeeping."""

    def __init__(self, csv_path: str, dataset_name: str, n_labels: int):
        import pandas as pd

        self.csv = pd.read_csv(csv_path)
        if dataset_name == "garden":
            self.balance_class = np.array([0, 2, 3, 4, 5, 6, 7])
            self.lowest = []
        elif dataset_name == "roses":
            self.balance_class = np.array([0, 1])
            self.lowest = []
        else:
            self.balance_class = np.array(
                [3, 4, 5, 6, 7, 9, 11, 12, 14, 15, 16, 17, 18]
            )
            self.lowest = [14, 15, 16]
        self.class_count = np.zeros(n_labels + 1)
        for i in self.balance_class:
            self.csv["count_" + str(i)] = np.ones(len(self.csv))

    def next_index(self, rng: np.random.Generator) -> Tuple[int, int]:
        counts = self.class_count[self.balance_class]
        mx = counts.max()
        if np.all(counts == mx):
            class_pos = int(rng.integers(0, len(self.balance_class)))
        else:
            under = np.where(counts < mx)[0]
            class_pos = int(under[rng.integers(0, len(under))])
        cls = int(self.balance_class[class_pos])
        col = str(cls)
        count_col = "count_" + col
        imgs = self.csv[self.csv[col] == 1]["n"].to_numpy()
        probs = self.csv[count_col][imgs].to_numpy()
        mx2 = probs.max()
        if np.all(probs == mx2):
            idx = int(imgs[rng.integers(0, len(imgs))])
        else:
            under = np.where(probs < mx2)[0]
            idx = int(imgs[under][rng.integers(0, len(under))])
        self.csv.loc[idx, count_col] += 1
        self.class_count[cls] += 0.5 if cls in self.lowest else 1
        return idx, cls


def build_datasets(cfg_data: DataConfig, output_activation: str, max_d: float,
                   normalize: np.ndarray, train: bool = True):
    """generateDataloaders equivalent (utilTorchDataLoader.py:633-707):
    train set with full augmentation (+kitti x5 replication), test set with
    crop [0,0] passthrough."""
    from .manifests import get_text_dataset

    (cl, cr, dp, sg, it, cl_t, cr_t, dp_t, sg_t, it_t) = get_text_dataset(cfg_data)
    name = cfg_data.dataset_name
    n_aug = 5 if name == "kitti" else 1
    rep = lambda lst: [j for j in lst for _ in range(n_aug)]
    x_train = list(zip(rep(cl), rep(cr)))
    y_train = list(zip(rep(dp), rep(sg), rep(it)))
    x_test = list(zip(cl_t, cr_t))
    y_test = list(zip(dp_t, sg_t, it_t))
    if cfg_data.n_data:
        x_train, y_train = x_train[: cfg_data.n_data], y_train[: cfg_data.n_data]

    balance_csv = cfg_data.class_balance_csv
    trainset = None
    if train:
        trainset = StereoSegDataset(
            x_train, y_train, cfg_data.n_labels, max_d, name, normalize,
            output_activation=output_activation,
            hdf5=cfg_data.train_compressed,
            class_balance_csv=balance_csv,
            transform=RandomCropAugment(
                tuple(cfg_data.crop), name, is_down=False,
                focus_person=True, resize_img=True, flip_horizontal=True,
            ),
            color_jitter=True,
        )
    testset = StereoSegDataset(
        x_test, y_test, cfg_data.n_labels, max_d, name, normalize,
        output_activation=output_activation, only_test=cfg_data.only_test,
        hdf5=cfg_data.test_compressed,
        transform=RandomCropAugment((0, 0), name, is_down=True),
    )
    return trainset, testset


def normalization_for(backbone: str, net: str) -> np.ndarray:
    """torch_implementation.py:759-762."""
    if "efficientnet" in backbone or "pspnet" in net:
        return np.array(
            [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]], np.float32
        )
    return np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
