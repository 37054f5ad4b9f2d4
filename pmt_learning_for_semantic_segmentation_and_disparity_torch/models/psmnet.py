"""PSMNet (stacked hourglass), ``pspnet``. Counterpart of the JAX package's
``models/psmnet.py`` (reference models_psmnet/stackhourglass.py,
submodule.py, process_input.py), NHWC in and out; the 2-D feature net runs
NCHW channels_last, the 3-D part NCDHW channels_last_3d.

* ``PSMFeature``: the CNN to 1/4 (3 + 16 + 3 + 3 basic blocks, the last
  three dilated by 2) and the SPP branches (VALID average pools of
  64/32/16/8, clamped to the map), concatenated raw, skip, b4, b3, b2, b1.
* ``ops.costvolume.concat_cost_volume`` over maxdisp / 4 planes, two 3-D
  conv pairs, three ``Hourglass3D``s (``_Deconv3dBN`` is flax's
  ``ConvTranspose`` with explicit (1, 2) padding: ``SameConvTranspose3d``)
  and their classifiers.
* ``ops.costvolume.upsampled_soft_argmin``: the upsample to full resolution,
  the softmax over D and the soft-argmin, by row chunks.
* ``pad_to_multiple_of_16`` pads H and W at the TOP and LEFT
  (process_input.py:4-31); the disparities are cropped back.

The net predicts disparity only: seg1 and seg2 are None (the step fakes them
with the ground truth). In train mode it also returns the three
classifiers' disparities as ``preds``. The feature net runs once per view in
train mode, one pass over both views stacked in eval mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..ops.costvolume import concat_cost_volume, upsampled_soft_argmin
from ..ops.resize import avg_pool, resize_bilinear
from .blocks import SameConvTranspose3d, batch_norm, conv2d, conv3d
from .sdnet import both_views, nchw_channels_last


class _ConvBN2d(nn.Module):
    """convbn (submodule.py:10-13): a bias-free conv padded by the dilation
    (or (k - 1) / 2 undilated) and its BatchNorm."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        pad = dilation if dilation > 1 else (kernel - 1) // 2
        self.conv = conv2d(cin, features, kernel, stride=stride, dilation=dilation, padding=pad)
        self.bn = batch_norm(features)

    def forward(self, x):
        return self.bn(self.conv(x))


class _BasicBlock(nn.Module):
    """BasicBlock (submodule.py:21-43), with a projected residual
    (``down``/``down_bn``: flax ``nn.Conv``'s default lecun init) where
    ``downsample``."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.c1 = _ConvBN2d(cin, planes, 3, stride, dilation)
        self.c2 = _ConvBN2d(planes, planes, 3, 1, dilation)
        if downsample:
            self.down = conv2d(cin, planes, 1, stride=stride, padding=0, init="lecun")
            self.down_bn = batch_norm(planes)

    def forward(self, x):
        out = self.c2(F.relu(self.c1(x)))
        if hasattr(self, "down"):
            x = self.down_bn(self.down(x))
        return out + x


class PSMFeature(nn.Module):
    """feature_extraction (submodule.py:66-141): the CNN to 1/4 and the SPP,
    32 channels out."""

    POOLS = (64, 32, 16, 8)

    def __init__(self, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for i, stride in enumerate((2, 1, 1)):
            self.add_module(f"first{i}", _ConvBN2d(cin, 32, 3, stride))
            cin = 32
        for i in range(3):
            self.add_module(f"l1_{i}", _BasicBlock(32, 32))
        for i in range(16):
            self.add_module(f"l2_{i}", _BasicBlock(32 if i == 0 else 64, 64, 2 if i == 0 else 1,
                                                   downsample=i == 0))
        for i in range(3):
            self.add_module(f"l3_{i}", _BasicBlock(64 if i == 0 else 128, 128, downsample=i == 0))
        # layer4: inplanes == planes at stride 1, so no downsample
        # (submodule.py:105-108), unlike layer3
        for i in range(3):
            self.add_module(f"l4_{i}", _BasicBlock(128, 128, dilation=2))
        for i in range(1, 5):
            self.add_module(f"branch{i}", _ConvBN2d(128, 32, 1))
        self.last0 = _ConvBN2d(64 + 128 + 4 * 32, 128, 3)
        self.last1 = conv2d(128, 32, 1)

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"first{i}")(x))
        for prefix, n in (("l1", 3), ("l2", 16)):
            for i in range(n):
                x = getattr(self, f"{prefix}_{i}")(x)
        raw = x
        for prefix in ("l3", "l4"):
            for i in range(3):
                x = getattr(self, f"{prefix}_{i}")(x)
        skip = x
        h, w = skip.shape[-2:]
        branches = []
        for i, pool in enumerate(self.POOLS, start=1):
            p = min(pool, h, w)
            b = F.relu(getattr(self, f"branch{i}")(avg_pool(skip, p, p)))
            branches.append(resize_bilinear(b, (h, w)))
        feat = torch.cat([raw, skip] + branches[::-1], dim=1)
        return self.last1(F.relu(self.last0(feat)))


class _ConvBN3d(nn.Module):
    """convbn_3d (submodule.py:16-19)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = conv3d(cin, features, stride)
        self.bn = batch_norm(features)

    def forward(self, x):
        return self.bn(self.conv(x))


class _Deconv3dBN(nn.Module):
    """ConvTranspose3d(k3, s2, pad 1, output_padding 1) + BN
    (stackhourglass.py:25-29)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.deconv = SameConvTranspose3d(cin, features)
        self.bn = batch_norm(features)

    def forward(self, x):
        return self.bn(self.deconv(x))


class Hourglass3D(nn.Module):
    """hourglass (stackhourglass.py:10-50)."""

    def __init__(self, inplanes: int):
        super().__init__()
        c = 2 * inplanes
        self.c1 = _ConvBN3d(inplanes, c, 2)
        self.c2 = _ConvBN3d(c, c, 1)
        self.c3 = _ConvBN3d(c, c, 2)
        self.c4 = _ConvBN3d(c, c, 1)
        self.c5 = _Deconv3dBN(c, c)
        self.c6 = _Deconv3dBN(c, inplanes)

    def forward(self, x, presqu: Optional[torch.Tensor], postsqu: Optional[torch.Tensor]):
        out = F.relu(self.c1(x))
        pre = self.c2(out)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = F.relu(self.c4(F.relu(self.c3(pre))))
        post = F.relu(self.c5(out) + (presqu if presqu is not None else pre))
        return self.c6(post), pre, post


def pad_to_multiple_of_16(left: torch.Tensor, right: torch.Tensor):
    """process_input.py:4-31: H and W padded up to a multiple of 16 at the
    top and left. NHWC; returns (left, right, (ph, pw))."""
    h, w = left.shape[1:3]
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    if ph or pw:
        pad = (0, 0, pw, 0, ph, 0)
        left, right = F.pad(left, pad), F.pad(right, pad)
    return left, right, (ph, pw)


class PSMNet(nn.Module):
    """stackhourglass.PSMNet: disparities only (seg faked by the step,
    torch_implementation.py:167-169)."""

    def __init__(self, maxdisp: int = 192):
        super().__init__()
        self.maxdisp = maxdisp
        self.feature = PSMFeature()
        self.dres0a = _ConvBN3d(64, 32)
        self.dres0b = _ConvBN3d(32, 32)
        self.dres1a = _ConvBN3d(32, 32)
        self.dres1b = _ConvBN3d(32, 32)
        for k in (2, 3, 4):
            self.add_module(f"dres{k}", Hourglass3D(32))
        for k in (1, 2, 3):
            self.add_module(f"classif{k}a", _ConvBN3d(32, 32))
            self.add_module(f"classif{k}b", conv3d(32, 1))

    def _classif(self, x, k: int):
        return getattr(self, f"classif{k}b")(F.relu(getattr(self, f"classif{k}a")(x)))

    def _regress(self, cost: torch.Tensor, hw: Tuple[int, int], pad: Tuple[int, int]):
        """(B, 1, D/4, H/4, W/4) -> the NHWC disparity, unpadded."""
        hp, wp = hw
        chunk = 32 if hp % 32 == 0 else (16 if hp % 16 == 0 else hp)
        d = upsampled_soft_argmin(cost[:, 0], self.maxdisp, (hp, wp), chunk=chunk)
        return d[:, pad[0]:, pad[1]:, None]

    def forward(self, left: torch.Tensor, right: torch.Tensor, **_) -> Dict[str, torch.Tensor]:
        lp, rp, pad = pad_to_multiple_of_16(left, right)
        ref, tgt = both_views(self.feature, nchw_channels_last(lp), nchw_channels_last(rp))
        cost = concat_cost_volume(ref, tgt, self.maxdisp // 4)
        c = F.relu(self.dres0b(F.relu(self.dres0a(cost))))
        cost0 = self.dres1b(F.relu(self.dres1a(c))) + c
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0
        cost1 = self._classif(out1, 1)
        cost2 = self._classif(out2, 2) + cost1
        cost3 = self._classif(out3, 3) + cost2
        hw = tuple(lp.shape[1:3])
        pred3 = self._regress(cost3, hw, pad)
        out = {"seg1": None, "disp1": pred3, "seg2": None, "disp2": pred3}
        if self.training:
            out["preds"] = (self._regress(cost1, hw, pad), self._regress(cost2, hw, pad), pred3)
        return out


@MODELS.register("pspnet")
def _make_psmnet(cfg: ModelConfig, labels: int) -> PSMNet:
    return PSMNet(maxdisp=cfg.max_disp_psm)
