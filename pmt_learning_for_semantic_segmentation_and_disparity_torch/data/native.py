"""ctypes bindings for the native (C++) data runtime: the port's counterpart
of the JAX package's ``data/native.py``.

``native/pmt_dataio.cc`` decodes whole ROSeS batches — PNG decode,
depth->disparity, one-hot, sobel edges, normalization — in one C call that
releases the GIL and fans out over a thread pool. The port compiles it with
``g++`` (libpng and zlib) into its own ``build/`` directory beside the CUDA
kernels (git-ignored), at first use, under a name that carries a hash of the
source and the flags. It never writes into ``native/`` and never loads the
library committed there. Where it cannot build or load (no ``g++``,
``png.h`` or ``libpng``), ``load_native()`` returns None and
``unavailable_reason()`` says why; ``StereoSegDataset(native_io="auto")``
then decodes with the port's own PNG codec and ``"on"`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "pmt_dataio.cc"
BUILD = _PKG / "build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lpng", "-lz", "-lpthread")
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD / f"libpmt_dataio_{digest}.so"


def build_native(force: bool = False) -> bool:
    """Compile the shared library into ``build/`` if needed. Returns
    availability; on failure ``unavailable_reason()`` holds the compiler's
    output."""
    global _reason
    if not SOURCE.exists():
        _reason = f"{SOURCE} is missing"
        return False
    path = library_path()
    if path.exists() and not force:
        return True
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        _reason = f"g++ did not run: {e}"
        return False
    if proc.returncode != 0:
        _reason = f"g++ exited {proc.returncode}: {proc.stderr.strip()[-2000:]}"
        return False
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return True


def load_native() -> Optional[ctypes.CDLL]:
    """The library, built if needed and loaded once; None where it cannot be
    built or loaded (see ``unavailable_reason``)."""
    global _lib, _reason
    if _lib is not None:
        return _lib
    if _reason is not None or not build_native():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError as e:
        _reason = f"{library_path()} does not load: {e}"
        return None
    lib.pmt_version.restype = ctypes.c_int
    lib.pmt_decode_roses_batch.restype = ctypes.c_int
    lib.pmt_decode_city_batch.restype = ctypes.c_int
    lib.pmt_read_png_gray16.restype = ctypes.c_int
    lib.pmt_read_png_rgb.restype = ctypes.c_int
    lib.pmt_png_info.restype = ctypes.c_int
    _lib = lib
    return lib


def unavailable_reason() -> Optional[str]:
    """Why the native library is unavailable (None if it loaded or was not
    tried yet)."""
    return None if _lib is not None else _reason


def native_available() -> bool:
    return load_native() is not None


def _charpp(strings: Sequence[str]):
    arr = (ctypes.c_char_p * len(strings))()
    arr[:] = [s.encode() for s in strings]
    return arr


def png_info(path: str):
    """(h, w, channels) of a png without decoding it."""
    lib = load_native()
    assert lib is not None
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.pmt_png_info(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c))
    if rc != 0:
        raise IOError(f"pmt_png_info({path}) -> {rc}")
    return h.value, w.value, c.value


def read_png_rgb(path: str) -> np.ndarray:
    lib = load_native()
    assert lib is not None
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.pmt_png_info(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c))
    if rc != 0:
        raise IOError(f"pmt_png_info({path}) -> {rc}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.pmt_read_png_rgb(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h.value, w.value,
    )
    if rc != 0:
        raise IOError(f"pmt_read_png_rgb({path}) -> {rc}")
    return out


_ACT = {"linear": 0, "sigmoid": 1, "tanh": 2, "relu": 0}


def decode_roses_batch(
    left_paths: Sequence[str],
    right_paths: Sequence[str],
    depth_paths: Sequence[str],
    seg_paths: Sequence[str],
    inst_paths: Sequence[str],
    hw,
    n_labels: int = 2,
    fb: float = 640.0 * 0.03,
    activation: str = "linear",
    max_d: float = 1.0,
    mean=(0.0, 0.0, 0.0),
    std=(1.0, 1.0, 1.0),
    n_threads: int = 8,
):
    """Returns dict of stacked float32 arrays (B,H,W,C)."""
    lib = load_native()
    assert lib is not None, f"native library unavailable: {_reason}"
    n = len(left_paths)
    h, w = hw
    left = np.empty((n, h, w, 3), np.float32)
    right = np.empty((n, h, w, 3), np.float32)
    disp = np.empty((n, h, w, 1), np.float32)
    seg = np.empty((n, h, w, n_labels), np.float32)
    edges = np.empty((n, h, w, 1), np.float32)
    meanv = np.asarray(mean, np.float32)
    stdv = np.asarray(std, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.pmt_decode_roses_batch(
        _charpp(left_paths), _charpp(right_paths), _charpp(depth_paths),
        _charpp(seg_paths), _charpp(inst_paths),
        n, h, w, n_labels, ctypes.c_float(fb), _ACT[activation],
        ctypes.c_float(max_d),
        meanv.ctypes.data_as(fp), stdv.ctypes.data_as(fp),
        left.ctypes.data_as(fp), right.ctypes.data_as(fp),
        disp.ctypes.data_as(fp), seg.ctypes.data_as(fp),
        edges.ctypes.data_as(fp), n_threads,
    )
    if rc != 0:
        raise IOError(f"pmt_decode_roses_batch -> {rc}")
    return {"left": left, "right": right, "disp": disp, "seg": seg,
            "edges": edges}


def decode_city_batch(
    left_paths: Sequence[str],
    right_paths: Sequence[str],
    disp_paths: Sequence[str],
    seg_paths: Sequence[str],
    inst_paths: Sequence[str],
    hw,
    lut: np.ndarray,
    n_labels: int = 19,
    activation: str = "linear",
    max_d: float = 1.0,
    mean=(0.0, 0.0, 0.0),
    std=(1.0, 1.0, 1.0),
    n_threads: int = 8,
):
    """kitti/cityscapes flavor: uint16 disparity png / 256, labelId ->
    trainId LUT (256 uint8, 255 = ignore -> last channel) one-hot over
    n_labels+1 channels, instance sobel edges. Returns stacked float32
    (B,H,W,C) arrays matching StereoSegDataset.load_raw."""
    lib = load_native()
    assert lib is not None, f"native library unavailable: {_reason}"
    n = len(left_paths)
    h, w = hw
    nc = n_labels + 1
    left = np.empty((n, h, w, 3), np.float32)
    right = np.empty((n, h, w, 3), np.float32)
    disp = np.empty((n, h, w, 1), np.float32)
    seg = np.empty((n, h, w, nc), np.float32)
    edges = np.empty((n, h, w, 1), np.float32)
    meanv = np.asarray(mean, np.float32)
    stdv = np.asarray(std, np.float32)
    lut8 = np.ascontiguousarray(np.asarray(lut, np.uint8))
    assert lut8.shape == (256,)
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.pmt_decode_city_batch(
        _charpp(left_paths), _charpp(right_paths), _charpp(disp_paths),
        _charpp(seg_paths), _charpp(inst_paths),
        n, h, w, nc, lut8.ctypes.data_as(u8p), _ACT[activation],
        ctypes.c_float(max_d),
        meanv.ctypes.data_as(fp), stdv.ctypes.data_as(fp),
        left.ctypes.data_as(fp), right.ctypes.data_as(fp),
        disp.ctypes.data_as(fp), seg.ctypes.data_as(fp),
        edges.ctypes.data_as(fp), n_threads,
    )
    if rc != 0:
        raise IOError(f"pmt_decode_city_batch -> {rc}")
    return {"left": left, "right": right, "disp": disp, "seg": seg,
            "edges": edges}
