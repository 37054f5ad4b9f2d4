"""The benchmark's frozen arithmetic: the card's peaks, the kernel families
of a device trace, the bytes and operations of the correlation kernels, and
the operations of a whole forward or train step.

* Peaks (NVIDIA H100 SXM data sheet, dense): 3.35 TB/s of HBM3; 495 TFLOP/s
  TF32 for fp32 inputs, 989 TFLOP/s for bf16. A kernel's share of its
  roofline is its least possible time, the larger of its bytes over the
  memory rate and its operations over the highest peak its input type can
  reach, over its measured time; so no implementation of the same work can
  read over 100%.
* Bytes: every input read once and every output written once. A forward
  reads f1 and f2 and writes the (B,H,W,P) output; a backward reads f1, f2
  and g and writes df1 and df2. Operations: a multiply and an add for every
  product a forward needs (2 P C a pixel), twice that for a backward.
* ``FAMILIES``: kernel-name fragments to a family, first match first; the
  table of the program's ``tools/profile_serve.py``, with the fp32 backward
  tile of corr1d (``corr::bwd_fp32_kernel``), which that table leaves in
  "other", and the correlations' backwards before their forwards.
* ``model_flops``: the convolutions' and matrix products' operations
  (``torch.utils.flop_counter``) of the reference net on the ``meta``
  device at the cell's shapes, the forward alone or forward and backward,
  plus the correlations' from the arithmetic above.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
ITEM_BYTES = {"float32": 4, "bfloat16": 2}
PATCH = {"corr1d": 17, "corr2d": 289}

FAMILIES = (
    ("corr2d_backward", ("corr2d_bwd",)),
    ("corr1d_backward", ("corr1d_bwd", "bwd_fp32_kernel")),
    ("corr1d", ("corr1d",)),
    ("corr2d", ("corr2d",)),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("concatenate", ("catarray",)),
    ("resize", ("upsample",)),
    ("pooling", ("pool",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("sort", ("sort", "radix")),
    ("copy_cast", ("copy_kernel", "direct_copy")),
    ("gather", ("gather", "scatter")),
    ("softmax", ("softmax",)),
    ("convolution", ("conv", "xmma", "implicit", "gemm", "cutlass", "fprop", "nvjet", "cudnn")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)
MEMORY_PASSES = ("batch_norm", "elementwise", "concatenate", "resize")


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def corr_bytes_flops(kernel: str, shape: Sequence[int], dtype: str = "float32",
                     backward: bool = False) -> Tuple[float, float]:
    """(bytes, operations) of one launch of ``kernel`` (corr1d, corr2d) at
    f1 = f2 = ``shape`` (B, H, W, C)."""
    b, h, w, c = shape
    pixels, patch, item = b * h * w, PATCH[kernel], ITEM_BYTES[dtype]
    if backward:
        return (4 * pixels * c + pixels * patch) * item, 4.0 * pixels * patch * c
    return (2 * pixels * c + pixels * patch) * item, 2.0 * pixels * patch * c


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """The least time of a kernel: bytes at the memory rate, operations at
    the dtype's highest peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def model_flops(net: str, labels: int, losses: Sequence[str], batch: int, height: int, width: int,
                train: bool) -> float:
    """Operations of one forward (``train=False``, eval mode) or one train
    step's forward and backward of the reference ``net`` on ``batch`` pairs
    of ``height`` x ``width``."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import losses as ref_losses
    from .reference import nets

    with torch.device("meta"):
        model = nets.build(net, labels).train(train)
        left, right = (torch.empty(batch, 3, height, width) for _ in range(2))
        counter = FlopCounterMode(display=False)
        with counter:
            if train:
                out = model(left, right)
                seg = torch.zeros(batch, height, width, labels)
                disp = torch.zeros(batch, height, width, 1)
                ref_losses.total(out, {"seg": seg, "disp": disp}, losses).backward()
            else:
                with torch.no_grad():
                    model(left, right)
    total = float(counter.get_total_flops())
    for kernel, shape in nets.corr_sites(net, batch, height, width):
        total += corr_bytes_flops(kernel, shape)[1]
        if train:
            total += corr_bytes_flops(kernel, shape, backward=True)[1]
    return total


def family_seconds(kernels: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Device seconds by family of (name, start_s, end_s) kernels."""
    out: Dict[str, float] = {}
    for name, start, end in kernels:
        fam = family(name)
        out[fam] = out.get(fam, 0.0) + (end - start)
    return out
