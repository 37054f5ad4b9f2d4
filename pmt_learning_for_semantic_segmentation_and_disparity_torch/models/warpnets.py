"""The warp family: seg heads blended through a learned attention over a
disparity-warped right-view prediction. Counterpart of the JAX package's
``models/warpnets.py`` (reference models/dsnet_t2_warp.py: minidsnetDivide
:577-703, minidsnetDivideSoftmax :169-309, minidsnetDivideDisp :704-836,
minidsnetDivideDisp2 :839-972, SmallsegNet :144-167; models/dsnet_t2.py
seg_dsnet :2087-2177), NHWC in and out, NCHW channels_last inside.

The output keys follow the reference's netForward mapping for the
``ThreeOutPuts*`` output types: seg1, disp1, seg2, disp2 (= disp1), seg3,
warped_right. The JAX package's quirks are kept, not fixed:

* ``dsnet_warp_soft`` feeds the LEFT view's /2 pyramid map ``a_py0`` to
  both seg heads (``warpnets.py:154``);
* ``dsnet_warp_disp`` warps the right IMAGE by the ground-truth disparity
  (the keyword input ``disp_gt``), masked by ``disp_gt > 0``, and runs the
  trunk a third time on it; ``dsnet_warp_disp_consist`` warps by the
  predicted disparity instead and returns the warped image;
* ``sdnet_seg`` returns the right image warped by its disparity as
  ``warped_right`` (the reference leaves it out, and its photo-consistency
  loss would then fail).

Every trunk runs as ``sdnet.both_views`` says: once per view in train mode
(the third pass of ``dsnet_warp_disp`` after them), one pass over both views
stacked in eval mode.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..ops.resize import resize_bilinear, resize_nearest, upsample_nearest
from ..ops.warp import apply_disparity
from .blocks import Conv2DownUp, ConvBN, ConvOut
from .pyramid import PiramidNet2Warp, PiramidNetV1
from .sdnet import (
    SegNetHead,
    both_views,
    channels_last,
    corr_patch,
    cost_volume,
    nchw_channels_last,
    nhwc,
)

# (segnet_input = b3 channels, segnet_feature = b1 channels) of the
# reference's constructor per backbone (dsnet_t2_warp.py:595-603); the port
# reads them off the pyramid, which gives these on these trunks
_WARP_DIMS = {
    "densenet": (576, 256),
    "resnet50": (1088, 384),
    "resnet101": (1088, 384),
    "mobilenet": (176, 152),
}


class SmallSegHead(nn.Module):
    """SmallsegNet (dsnet_t2_warp.py:144-167): no initial x2 upsample;
    returns (x after cdu1, x1_1 after the low-level concat conv, seg)."""

    def __init__(self, cin: int, skip_channels: int, labels: int):
        super().__init__()
        self.conv1d_1 = ConvBN(cin, 64, 1, batchnorm=False, relu=True)
        self.cdu1 = Conv2DownUp(64, 32, 3)
        self.conv1d_2 = ConvBN(32 + skip_channels, 32, 1, batchnorm=False, relu=True)
        self.cdu2 = Conv2DownUp(32, 32, 3, last_layer=False)
        self.out = ConvOut(32, labels, 3)

    def forward(self, x, full_hw: Tuple[int, int], xleft):
        x = self.cdu1(self.conv1d_1(x))
        x1_1 = self.conv1d_2(torch.cat([resize_nearest(x, xleft.shape[-2:]), xleft], dim=1))
        seg = self.out(self.cdu2(x1_1))
        return x, x1_1, resize_nearest(seg, full_hw)


class _WarpCommon(nn.Module):
    """The disparity decoder the family shares (dsnet_t2_warp.py:664-684):
    the correlation of the /8 pyramid maps (1-D, or 17x17 normalized under
    2dcorr), fused with the seg head's /16 features, to full resolution."""

    def _disp_decoder_modules(self, cfg: ModelConfig, head_channels: int = 32):
        self.patch = corr_patch(cfg)
        self.normalize = cfg.corr_type != "1dcorr"
        self.corrConv2d = ConvBN(self.patch[0] * self.patch[1], 128, 1, batchnorm=False, relu=True)
        self.cdu3 = Conv2DownUp(head_channels, 128, 3)
        self.cdu4 = Conv2DownUp(256, 64, 3)
        self.conv1d_2 = ConvBN(64 + 1, 64, 1, batchnorm=False, relu=True)
        self.cdu5 = Conv2DownUp(64, 64, 5, last_layer=False)
        self.dispoutConv = ConvOut(64, 1, 5)

    def disp_decoder(self, x, a_py2, b_py2, xleft2, full_hw):
        """(disparity at full resolution, the 64-channel /8 features y); ``x``
        is the seg head's 32-channel /16 map."""
        y = self.corrConv2d(cost_volume(a_py2, b_py2, self.patch, self.normalize))
        y1 = resize_bilinear(self.cdu3(x), y.shape[-2:])
        y = self.cdu4(torch.cat([y1, y], dim=1))
        y2 = upsample_nearest(y, 8)
        xl2 = resize_bilinear(xleft2, y2.shape[-2:])
        disp = self.dispoutConv(self.cdu5(self.conv1d_2(torch.cat([y2, xl2], dim=1))))
        return resize_bilinear(disp, full_hw), y


def _blend(at: torch.Tensor, seg_left: torch.Tensor, seg_right: torch.Tensor) -> torch.Tensor:
    return (1.0 - at) * seg_left + at * seg_right


class MiniDSNetDivide(_WarpCommon):
    """The warp nets on ``PiramidNet2Warp``. ``variant``:

    * "divide" (``dsnet_warp``): the left and right seg predictions blended
      by a sigmoid attention; the right one warped into the left view by the
      predicted disparity;
    * "soft" (``dsnet_warp_soft``): a per-class softmax blend, the seg heads
      tapping the left view's /2 map;
    * "disp" (``dsnet_warp_disp``): the right image warped by the ground
      truth disparity runs the trunk and the seg head a third time;
    * "disp2" (``dsnet_warp_disp_consist``): the same, warped by the
      predicted disparity."""

    VARIANTS = ("divide", "soft", "disp", "disp2")

    def __init__(self, cfg: ModelConfig, labels: int = 2, variant: str = "divide"):
        super().__init__()
        if variant not in self.VARIANTS:
            raise ValueError(f"variant {variant!r}: one of {self.VARIANTS}")
        self.variant = variant
        self.features = PiramidNet2Warp(cfg.backbone)
        c_py0, c_py1, c_py3 = (self.features.out_channels[i] for i in (5, 6, 8))
        self.conv2d_ba1 = ConvBN(3, 1, 5, dilation=2, relu=True)
        skip = c_py0 if variant == "soft" else c_py1
        self.segNet = SmallSegHead(c_py3, skip, labels)
        self._disp_decoder_modules(cfg)
        if variant == "soft":
            self.cdu7 = Conv2DownUp(96, 64, 3, last_layer=False)
            self.cdu7_out = ConvOut(64, labels, 3)
        else:
            self.cdu7 = Conv2DownUp(96 if variant == "divide" else 128, 64, 3)
            self.conv1d_at_d = ConvBN(64, 1, 1, batchnorm=False)

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor, disp_gt=None,
                **_) -> Dict[str, torch.Tensor]:
        left, right = nchw_channels_last(input_a), nchw_channels_last(input_b)
        full_hw = tuple(left.shape[-2:])
        disp_variant = self.variant in ("disp", "disp2")
        # taps 0..4, then the enriched b0, b1, b2, b3 (indices 5..8)
        a, b = both_views(self.features, left, right)
        a_py0, a_py1, a_py2, a_py3 = a[5:9]
        b_py0, b_py1, b_py2, b_py3 = b[5:9]

        xleft2 = channels_last(self.conv2d_ba1(left))
        if self.variant == "soft":
            x, x1_1, seg_left = self.segNet(a_py3, full_hw, a_py0)
            _, _, seg_right = self.segNet(b_py3, full_hw, a_py0)
        else:
            x, x1_1, seg_left = self.segNet(a_py3, full_hw, a_py1)
            if not disp_variant:
                _, _, seg_right = self.segNet(b_py3, full_hw, b_py1)

        disp_out, y = self.disp_decoder(x, a_py2, b_py2, xleft2, full_hw)
        disp = nhwc(disp_out)
        y3 = resize_nearest(y, x1_1.shape[-2:])

        if disp_variant:
            if self.variant == "disp2":
                warped_right = apply_disparity(input_b, -disp)
            else:
                if disp_gt is None:
                    raise ValueError("dsnet_warp_disp needs the ground-truth disparity disp_gt")
                warped_right = apply_disparity(input_b, -disp_gt) * (disp_gt > 0).to(input_b.dtype)
            wb = self.features(nchw_channels_last(warped_right))
            _, x2_1, seg_right = self.segNet(wb[8], full_hw, wb[6])
            at = torch.sigmoid(self.conv1d_at_d(self.cdu7(torch.cat([x1_1, x2_1, y3], dim=1))))
            at = nhwc(resize_nearest(at, full_hw))
            seg_both = _blend(at, nhwc(seg_left), nhwc(seg_right))
            extra = warped_right if self.variant == "disp2" else at
            return {"seg1": seg_both, "disp1": disp, "seg2": nhwc(seg_left), "disp2": disp,
                    "seg3": nhwc(seg_right), "warped_right": extra}

        s2_d = torch.cat([x1_1, y3], dim=1)
        if self.variant == "soft":
            at = nhwc(resize_nearest(self.cdu7_out(self.cdu7(s2_d)), full_hw)).softmax(dim=-1)
        else:
            at = nhwc(resize_nearest(torch.sigmoid(self.conv1d_at_d(self.cdu7(s2_d))), full_hw))
        seg_right_w = apply_disparity(nhwc(seg_right), -disp)
        seg_both = _blend(at, nhwc(seg_left), seg_right_w)
        if self.variant == "soft":
            return {"seg1": nhwc(seg_left), "disp1": disp, "seg2": seg_both, "disp2": disp,
                    "seg3": seg_right_w, "warped_right": at}
        return {"seg1": seg_both, "disp1": disp, "seg2": nhwc(seg_left), "disp2": disp,
                "seg3": seg_right_w, "warped_right": at}


class SegDSNet(_WarpCommon):
    """seg_dsnet, ``sdnet_seg`` (dsnet_t2.py:2087-2177): one ``SegNetHead``
    shared by the views over the deepest tap (with the shared ``conv2d_ba0``
    image conv as its skip), on the original piramidNet (``PiramidNetV1``,
    densenet121), the disparity trained self-supervised (photo-consistency,
    output type smallOutWarp). Returns seg1 (left), seg2 (the right view's
    seg warped into the left), disp1 = disp2 and ``warped_right``."""

    def __init__(self, cfg: ModelConfig, labels: int = 2):
        super().__init__()
        self.features = PiramidNetV1()
        c4 = self.features.out_channels[4]
        # in the JAX model's call order: conv2d_ba1 runs first
        self.conv2d_ba1 = ConvBN(3, 1, 5, dilation=2, relu=True)
        self.conv2d_ba0 = ConvBN(3, 1, 5, dilation=2, relu=True)
        self.segNet = SegNetHead(c4, labels)
        self._disp_decoder_modules(cfg)

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor, **_) -> Dict[str, torch.Tensor]:
        left, right = nchw_channels_last(input_a), nchw_channels_last(input_b)
        full_hw = tuple(left.shape[-2:])
        a, b = both_views(self.features, left, right)
        a4, a_py2 = a[4], a[5]
        b4, b_py2 = b[4], b[5]
        xleft2 = channels_last(self.conv2d_ba1(left))
        xleft0 = channels_last(self.conv2d_ba0(left))
        xright0 = channels_last(self.conv2d_ba0(right))
        _, x1, seg_left = self.segNet(a4, full_hw, xleft0)
        _, _, seg_right = self.segNet(b4, full_hw, xright0)
        disp_out, _ = self.disp_decoder(x1, a_py2, b_py2, xleft2, full_hw)
        disp = nhwc(disp_out)
        return {"seg1": nhwc(seg_left), "disp1": disp,
                "seg2": apply_disparity(nhwc(seg_right), -disp), "disp2": disp,
                "warped_right": apply_disparity(input_b, -disp)}


@MODELS.register("dsnet_warp")
def _make_divide(cfg: ModelConfig, labels: int) -> MiniDSNetDivide:
    return MiniDSNetDivide(cfg, labels=labels)


@MODELS.register("dsnet_warp_soft")
def _make_divide_soft(cfg: ModelConfig, labels: int) -> MiniDSNetDivide:
    return MiniDSNetDivide(cfg, labels=labels, variant="soft")


@MODELS.register("dsnet_warp_disp")
def _make_divide_disp(cfg: ModelConfig, labels: int) -> MiniDSNetDivide:
    return MiniDSNetDivide(cfg, labels=labels, variant="disp")


@MODELS.register("dsnet_warp_disp_consist")
def _make_divide_disp2(cfg: ModelConfig, labels: int) -> MiniDSNetDivide:
    return MiniDSNetDivide(cfg, labels=labels, variant="disp2")


@MODELS.register("sdnet_seg")
def _make_seg_dsnet(cfg: ModelConfig, labels: int) -> SegDSNet:
    return SegDSNet(cfg, labels=labels)
