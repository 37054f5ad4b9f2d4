"""Forward and on-device metrics of the eval step (the part of the JAX
package's ``training/step.py`` that the serving slice needs; the losses, the
train step and the per-row eval step come with the training slice)."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch.func import functional_call

from ..core.config import PMTConfig
from ..core.device import resolve_device
from ..metrics.dispmetrics import disp_metrics
from ..metrics.segmetrics import seg_batch_metrics


def make_forward_fn(cfg: PMTConfig, model: torch.nn.Module,
                    device: Optional[Union[str, torch.device]] = None):
    """Returns ``forward(batch) -> outputs``: the eval forward of ``model`` on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``; the model is moved there).

    ``batch`` holds NHWC ``left``/``right`` images; the outputs are the
    model's dict of NHWC tensors in fp32. With ``cfg.parallel.bf16`` the
    weights and images are cast to bf16 for the forward (the fp32 master
    weights in ``model`` stay as they are) and the outputs are cast back to
    fp32, as the JAX package's bf16 policy does."""
    device = resolve_device(device)
    if cfg.model.edges:
        raise NotImplementedError("edge-input nets are not ported yet (ROADMAP.md queue 1, item 12.7)")
    model.to(device).eval()
    bf16 = cfg.parallel.bf16

    def forward(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left = batch["left"].to(device)
        right = batch["right"].to(device)
        if not bf16:
            return model(left, right)
        state = {name: t.to(torch.bfloat16) if t.dtype == torch.float32 else t
                 for name, t in (*model.named_parameters(), *model.named_buffers())}
        out = functional_call(model, state, (left.to(torch.bfloat16), right.to(torch.bfloat16)))
        return {k: v.float() for k, v in out.items()}

    return forward


def compute_metrics(cfg: PMTConfig, out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                    pixel_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """On-device metric pack for both heads + disparity."""
    n = cfg.data.n_labels
    m1 = seg_batch_metrics(out["seg1"], batch["seg"], n, pixel_mask)
    m2 = seg_batch_metrics(out["seg2"], batch["seg"], n, pixel_mask)
    use_mask = cfg.data.dataset_name not in ("garden", "roses")
    dm = disp_metrics(out["disp1"], batch["disp"], batch["seg"], cfg.model.max_disp,
                      mask_invalid=use_mask, pixel_mask=pixel_mask)
    return {
        "pixel_acc1": m1.pixel_acc, "pixel_acc2": m2.pixel_acc,
        "conf1": m1.confusion, "conf2": m2.confusion,
        "prec2": m2.precision, "recall2": m2.recall,
        "f1_2": m2.f1, "bf1_2": m2.branch_f1,
        "disp_err3px": dm.err_gt3px, "disp_valid": dm.valid_px,
        "disp_rmse": dm.rmse, "disp_sqrel": dm.sq_rel,
        "disp_brmse": dm.branch_rmse, "disp_bsqrel": dm.branch_sq_rel,
    }
