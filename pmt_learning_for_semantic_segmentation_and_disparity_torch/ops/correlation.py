"""Stereo patch correlation (cost volume), NHWC in / (B,H,W,ph*pw) out.

Semantics of the JAX package's ``ops/correlation.py``:

    out[b, y, x, i*pw + j] = sum_c f1[b,y,x,c] * f2[b, y+i-ph//2, x+j-pw//2, c]

with zeros outside the image, and for ``normalize=True`` a division by the
channel count.

* ``correlation_plain``  -- shift-multiply-sum in plain PyTorch, the
  counterpart of ``correlation_lax``. It runs on CPU tensors and is the
  reference the CUDA kernels are held against on the card; autograd through
  it is the CPU path's backward.
* ``correlation1d_vjp_plain`` / ``correlation2d_vjp_plain`` -- the analytic
  gradients (df1, df2) in plain PyTorch, counterparts of ``_corr1d_bwd_lax``
  and ``_corr2d_bwd_lax``; the references of the backward kernel.
* ``correlation1d_cuda`` -- the hand-written Hopper kernel for the 1-D
  (1, 17) patch (``csrc/corr1d.cu``), counterpart of ``correlation1d_pallas``.
* ``correlation1d_backward_cuda`` -- the hand-written Hopper kernel for
  corr1d's gradients (``corr1d_backward`` in ``csrc/corr1d.cu``: bf16 as a
  transposed band on the tensor cores, fp32 on the CUDA cores), which
  ``correlation1d_cuda``'s backward launches.
* ``correlation2d_cuda`` -- the hand-written Hopper kernel for the 2-D
  (17, 17) patch (``csrc/corr2d.cu``), counterpart of ``correlation2d_pallas``.
* ``correlation2d_backward_cuda`` -- the hand-written Hopper kernel for
  corr2d's gradients (``corr2d_backward`` in ``csrc/corr2d.cu``: bf16 as a
  relayout of g into per-offset slices, then a persistent band over 4 output
  rows and 128 channels an item, df2 as df1 of the mirrored g: on the tensor
  cores in bf16, in fp32 FMAs on the CUDA cores), which
  ``correlation2d_cuda``'s backward launches.

  Both kernels run bf16 inputs on the tensor cores (the band tile of
  ``csrc/corr_band.cuh``) and fp32 inputs on the CUDA cores (corr1d
  ``corr1d_fp32_kernel`` of ``csrc/corr_tile.cuh``: 64-column row tiles fed
  by a ring of 32-channel ``cp.async`` stages; corr2d its own kernel of 4-row
  blocks in ``csrc/corr2d.cu``); either takes any C, H and W the checks
  below let through. Which copies a launch takes is chosen by shape and
  alignment before it: ``vec`` inputs (C a multiple of 16 bytes' elements,
  16-byte aligned) are copied by the copy engine or ``cp.async``, the rest
  staged by element loads in the same kernel.
* ``correlation``        -- the dispatcher: CPU tensors take the plain
  version, any other tensor the kernel of its patch (``ph == 1``: corr1d,
  else corr2d), which raises if the tensors are not on the card or the kernel
  cannot be built or launched; there is no fallback on the card.

On the card both correlations train through their backward kernels; the
division by C of ``normalize=True`` stays outside the kernels, so autograd
scales the output gradient itself.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _kernels

# the patch each kernel is compiled for
KERNEL_PATCH = {"corr1d": (1, 17), "corr2d": (17, 17)}


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, patch: Tuple[int, int],
                      normalize: bool = False) -> torch.Tensor:
    """Patch correlation in plain PyTorch; products in the input dtype."""
    ph, pw = patch
    rh, rw = ph // 2, pw // 2
    b, h, w, c = f1.shape
    f2p = F.pad(f2, (0, 0, rw, rw, rh, rh))
    outs = []
    for i in range(ph):
        for j in range(pw):
            outs.append((f1 * f2p[:, i:i + h, j:j + w, :]).sum(-1))
    out = torch.stack(outs, dim=-1)
    if normalize:
        out = out / c
    return out


def _halo_views(h: int, w: int, i: int, j: int, rh: int, rw: int):
    """For the shift (i, j): the (rows, cols) slices of an output map and of
    the f2 map they read, where both lie inside the image (empty where the
    shift is larger than the map)."""
    oy, ox = i - rh, j - rw
    out = (slice(max(0, -oy), max(0, h - oy)), slice(max(0, -ox), max(0, w - ox)))
    src = (slice(max(0, oy), max(0, h + oy)), slice(max(0, ox), max(0, w + ox)))
    return out, src


def correlation2d_vjp_plain(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                            patch: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(df1, df2) of ``correlation_plain(f1, f2, patch)`` (no normalize) for
    the output gradient ``g`` (B,H,W,ph*pw):

        df1[b,y,x,c]  = sum_ij g[b,y,x,ij] * f2[b,y+i-rh,x+j-rw,c]
        df2[b,y',x',c] = sum_ij g[b,y'-i+rh,x'-j+rw,ij] * f1[b,y'-i+rh,x'-j+rw,c]

    with zero terms outside the image. Products in the input dtype, sums in
    fp32, returned in the input dtype."""
    ph, pw = patch
    b, h, w, c = f1.shape
    df1 = torch.zeros(f1.shape, dtype=torch.float32, device=f1.device)
    df2 = torch.zeros_like(df1)
    for i in range(ph):
        for j in range(pw):
            (oy, ox), (sy, sx) = _halo_views(h, w, i, j, ph // 2, pw // 2)
            gd = g[:, oy, ox, i * pw + j, None]
            df1[:, oy, ox] += gd * f2[:, sy, sx]
            df2[:, sy, sx] += gd * f1[:, oy, ox]
    return df1.to(f1.dtype), df2.to(f2.dtype)


def correlation1d_vjp_plain(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                            pw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(df1, df2) of the 1-D correlation with patch (1, pw): the reference
    of ``correlation1d_backward_cuda``."""
    return correlation2d_vjp_plain(f1, f2, g, (1, pw))


def _check_pair(name: str, f1: torch.Tensor, f2: torch.Tensor) -> None:
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"{name} needs both inputs on one CUDA device, "
                         f"got {f1.device} and {f2.device}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise ValueError(f"{name} takes fp32 or bf16, got {f1.dtype}, {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"{name} needs two equal (B,H,W,C) shapes, "
                         f"got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError(f"{name} needs contiguous NHWC inputs")


def forward_plan(name: str, c: int) -> dict:
    """The plan the bf16 forward kernel ``name`` (corr1d, corr2d) takes for
    ``c`` channels, as its launch computes it: stages of the ring, 64-channel
    boxes a stage, whether f1's tile stays resident in shared memory, and the
    dynamic shared memory of a block."""
    fn = getattr(_kernels.load(name), f"{name}_forward_plan")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 4)()
    fn(c, out)
    return {"stages": out[0], "boxes_per_stage": out[1], "f1_resident": bool(out[2]),
            "smem_bytes": out[3]}


def _launch(name: str, f1: torch.Tensor, f2: torch.Tensor, patch: Tuple[int, int]) -> torch.Tensor:
    """Check the inputs, then run the ``csrc/<name>.cu`` kernel on the
    current stream. Everything is checked before the kernel is built."""
    _check_pair(name, f1, f2)
    ph, pw = patch
    if (ph, pw) != KERNEL_PATCH[name]:
        raise ValueError(f"{name} is built for the patch {KERNEL_PATCH[name]}, got {(ph, pw)}")
    b, h, w, c = f1.shape
    if min(b, h, w, c) == 0 or max(b, h) > 65535 or max(f1.numel(), b * h * w * ph * pw) >= 2**31:
        raise ValueError(f"{name}: unsupported shape {tuple(f1.shape)}")
    fn = getattr(_kernels.load(name), f"{name}_forward")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, h, w, ph * pw), dtype=f1.dtype, device=f1.device)
    # 16-byte vector loads need whole vectors per pixel and aligned rows;
    # otherwise the kernels stage the same layout with element loads
    vec = (c % (16 // f1.element_size()) == 0
           and f1.data_ptr() % 16 == 0 and f2.data_ptr() % 16 == 0)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, ph, pw,
                 int(f1.dtype == torch.bfloat16), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def backward_workspace_bytes(b: int, h: int, w: int, c: int, bf16: bool) -> int:
    """The bytes of scratch ``corr2d_backward`` takes at this shape: g's
    relayout into per-offset slices (``csrc/corr2d.cu``), in the input dtype
    (twice bf16's bytes in fp32)."""
    fn = _kernels.load("corr2d").corr2d_backward_workspace
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_size_t
    return int(fn(b, h, w, c, int(bf16)))


def _launch_backward(name: str, f1: torch.Tensor, f2: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs, then run ``<name>_backward`` of ``csrc/<name>.cu``
    on the current stream: (df1, df2) for the output gradient ``g``; corr2d
    gets its workspace (``backward_workspace_bytes``) allocated here.
    Everything is checked before the kernel is built."""
    what = f"{name} backward"
    _check_pair(what, f1, f2)
    b, h, w, c = f1.shape
    ph, pw = KERNEL_PATCH[name]
    if g.shape != (b, h, w, ph * pw) or g.dtype != f1.dtype or g.device != f1.device:
        raise ValueError(f"{what} needs g of shape {(b, h, w, ph * pw)} and dtype "
                         f"{f1.dtype} on {f1.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    if min(b, h, w, c) == 0 or max(b, h) > 65535 or max(f1.numel(), g.numel()) >= 2**31:
        raise ValueError(f"{what}: unsupported shape {tuple(f1.shape)}")
    g = g.contiguous()
    fn = getattr(_kernels.load(name), f"{name}_backward")
    extra = ()
    if name == "corr2d":
        nbytes = backward_workspace_bytes(b, h, w, c, f1.dtype == torch.bfloat16)
        work = torch.empty(nbytes, dtype=torch.uint8, device=f1.device)
        extra = (work.data_ptr() if nbytes else None,)
    fn.argtypes = [ctypes.c_void_p] * (5 + len(extra)) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    # as in _launch, and for the outputs too: bf16 copies the inputs in
    # through tensor maps and stores pairs, fp32 uses 16-byte copies and stores
    vec = (c % (16 // f1.element_size()) == 0
           and all(t.data_ptr() % 16 == 0 for t in (f1, f2, df1, df2)))
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), g.data_ptr(), df1.data_ptr(), df2.data_ptr(),
                 *extra, b, h, w, c, int(f1.dtype == torch.bfloat16), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return df1, df2


def correlation1d_backward_cuda(f1: torch.Tensor, f2: torch.Tensor,
                                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(df1, df2) of the 1-D (1, 17) correlation on the card with the
    ``corr1d_backward`` kernel of ``csrc/corr1d.cu``; ``g`` is the output
    gradient (B,H,W,17). ``correlation1d_backward_cuda.launches`` counts the
    kernel's launches."""
    out = _launch_backward("corr1d", f1, f2, g)
    correlation1d_backward_cuda.launches += 1
    return out


def correlation2d_backward_cuda(f1: torch.Tensor, f2: torch.Tensor,
                                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(df1, df2) of the 2-D (17, 17) correlation (no normalize) on the card
    with the ``corr2d_backward`` kernel of ``csrc/corr2d.cu``; ``g`` is the
    output gradient (B,H,W,289), taken as it is: in bf16 the kernel's own
    relayout pass rewrites it into the workspace first.
    ``correlation2d_backward_cuda.launches`` counts the kernel's launches."""
    out = _launch_backward("corr2d", f1, f2, g)
    correlation2d_backward_cuda.launches += 1
    return out


class _Corr1dCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, pw):
        out = _launch("corr1d", f1, f2, (1, pw))
        correlation1d_cuda.launches += 1
        ctx.save_for_backward(f1, f2)
        return out

    @staticmethod
    def backward(ctx, grad):
        f1, f2 = ctx.saved_tensors
        df1, df2 = correlation1d_backward_cuda(f1, f2, grad)
        return df1, df2, None


class _Corr2dCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, patch):
        out = _launch("corr2d", f1, f2, patch)
        correlation2d_cuda.launches += 1
        ctx.save_for_backward(f1, f2)
        return out

    @staticmethod
    def backward(ctx, grad):
        f1, f2 = ctx.saved_tensors
        df1, df2 = correlation2d_backward_cuda(f1, f2, grad)
        return df1, df2, None


def correlation1d_cuda(f1: torch.Tensor, f2: torch.Tensor, pw: int) -> torch.Tensor:
    """1-D horizontal correlation on the card with the ``csrc/corr1d.cu``
    kernel; NHWC in, (B,H,W,pw) out. ``correlation1d_cuda.launches`` counts
    the kernel's launches."""
    return _Corr1dCuda.apply(f1, f2, pw)


def correlation2d_cuda(f1: torch.Tensor, f2: torch.Tensor, patch: Tuple[int, int]) -> torch.Tensor:
    """2-D patch correlation on the card with the ``csrc/corr2d.cu`` kernel;
    NHWC in, (B,H,W,ph*pw) out. ``correlation2d_cuda.launches`` counts the
    kernel's launches."""
    return _Corr2dCuda.apply(f1, f2, tuple(patch))


correlation1d_cuda.launches = 0
correlation1d_backward_cuda.launches = 0
correlation2d_cuda.launches = 0
correlation2d_backward_cuda.launches = 0


def correlation(f1: torch.Tensor, f2: torch.Tensor, patch: Tuple[int, int],
                normalize: bool = False) -> torch.Tensor:
    """Dispatch by where the tensors lie: plain PyTorch on the CPU, the
    hand-written kernel of the patch on the card."""
    ph, pw = patch
    if f1.dtype != f2.dtype or f1.device != f2.device:
        raise ValueError(f"correlation takes two tensors of one dtype on one device, got "
                         f"{f1.dtype} on {f1.device} and {f2.dtype} on {f2.device}")
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, patch, normalize=normalize)
    out = correlation1d_cuda(f1, f2, pw) if ph == 1 else correlation2d_cuda(f1, f2, patch)
    if normalize:
        # a scalar scale in the output dtype, kept outside the kernel as in
        # the JAX package
        out = out / f1.shape[-1]
    return out
