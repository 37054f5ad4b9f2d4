"""Multi-format image IO (host side, numpy): the port's counterpart of the
JAX package's ``data/imageio.py``.

Mirror of util/utilIOPfm.py:13-226: extension-dispatched read/write for
pfm (with endianness/scale header), png, pgm (ASCII P2), ppm/jpg, flo,
float3, bin. PNGs go through the port's own codec (``data/png.py``) with
cv2's conventions (``read_png`` returns BGR, 3-channel even for depth pngs,
like the reference). Only ppm/jpg and non-PNG writes use cv2, imported where
they run; without it they raise.
"""
from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from . import png


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading or writing this format needs cv2 (opencv-python), which is "
                          "not installed; PNG and PFM need nothing") from e
    return cv2


def read(path: str) -> np.ndarray:
    if path.endswith(".float3"):
        return read_float3(path)
    if path.endswith(".flo"):
        return read_flo(path)
    if path.endswith(".ppm") or path.endswith(".jpg"):
        return read_image(path)
    if path.endswith(".pgm"):
        return read_pgm(path)
    if path.endswith(".png"):
        return read_png(path)
    if path.endswith(".bin"):
        return read_bin(path)
    if path.endswith(".pfm"):
        return read_pfm(path)[0]
    raise ValueError(f"don't know how to read {path}")


def write(path: str, data: np.ndarray) -> None:
    if path.endswith(".pfm"):
        write_pfm(path, data)
        return
    if path.endswith(".png"):
        png.write(path, data)
        return
    _cv2().imwrite(path, data)


def read_png(path: str) -> np.ndarray:
    """cv2.imread, BGR, like the reference (utilIOPfm.py:37-38)."""
    return png.read(path)


def read_image(path: str) -> np.ndarray:
    """cv2.imread(path, -1): the stored samples, gray 2-D, colour BGR."""
    if path.endswith(".png"):
        return png.read(path, unchanged=True)
    img = _cv2().imread(path, -1)
    if img is None:
        raise FileNotFoundError(path)
    return img


def read_rgb(path: str) -> np.ndarray:
    """RGB uint8 (the skimage io.imread path of the dataset,
    utilTorchDataLoader.py:146-147); keeps only the first 3 channels."""
    img = read_image(path)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[2] >= 3:
        img = img[:, :, :3][:, :, ::-1]  # BGR->RGB
    return np.ascontiguousarray(img)


def read_bin(path: str) -> np.ndarray:
    x = np.fromfile(path, dtype=">f4")
    return np.reshape(x, [480, 640], order="F")


def read_pgm(path: str) -> np.ndarray:
    with open(path) as f:
        lines = [l for l in f.readlines() if not l.startswith("#")]
    assert lines[0].strip() == "P2"
    data = []
    for line in lines[1:]:
        data.extend(int(c) for c in line.split())
    w, h = data[0], data[1]
    return np.reshape(np.array(data[3:]), (h, w))


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("ascii"))
        if not dim:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(np.reshape(data, shape)), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype.name != "float32":
        raise ValueError("Image dtype must be float32.")
    image = np.flipud(image)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("Image must be HxWx3, HxWx1 or HxW.")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            raise ValueError("Invalid .flo file")
        w = int(np.fromfile(f, np.int32, count=1))
        h = int(np.fromfile(f, np.int32, count=1))
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return np.resize(data, (h, w, 2))


def read_float3(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if (f.readline().decode("utf-8")).strip() != "float3":
            raise ValueError("float3 header missing")
        dims = [int(f.readline()) for _ in range(3)]
        data = np.fromfile(f, np.float32, dims[0] * dims[1] * dims[2])
    return data.reshape(dims[1], dims[0], dims[2])
