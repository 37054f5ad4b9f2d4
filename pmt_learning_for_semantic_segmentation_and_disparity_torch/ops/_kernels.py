"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, at first use, into
``build/`` beside the package (listed in ``.gitignore``). The library's name
carries a hash of its source and of the shared headers (``csrc/*.cuh``), so
an edited source is rebuilt and a stale library is never loaded. Nothing here
runs at import time: the CPU tests import every module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# kernel name -> source file under csrc/
SOURCES = {"corr1d": "corr1d.cu", "corr2d": "corr2d.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    inputs = [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in inputs)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Raises with the compiler's output if one
    fails. Returns name -> library path."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[n])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built if needed and loaded once."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
