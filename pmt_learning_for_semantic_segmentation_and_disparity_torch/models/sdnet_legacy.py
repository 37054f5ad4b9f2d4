"""The original two-head SDNet (``sdnet``) and its v2 (``sdnetv2``), eval
and train forward.

Counterpart of the JAX package's ``models/sdnet_legacy.py`` (reference
dsnet_t2.py dsnet :119-321, dsnetv2 :402-616), NHWC in and out like the
flagship, NCHW channels_last inside. Both run the original piramidNet
(``PiramidNetV1``), a correlation at 1/8 normalized by the channel count, a
coarse seg head, the disparity head, and the refined seg and disparity heads
with residual head mixing. The JAX package's quirks are kept:

* three separate 3 -> 1 image convs ``conv2d_ba1..3`` (a fourth,
  ``conv2d_ba0``, in ``sdnetv2``), each 5x5 dilation 2 with BN and ReLU;
* ``sdnet``'s head 1 is inline and log-softmaxed; ``sdnetv2``'s is the
  ``segNet`` helper and gives raw logits, so its seg2 = 0.9 * log_softmax(s2)
  + 0.1 * seg1 mixes log-probabilities with raw logits (:232);
* ``sdnet`` always correlates the 17x17 patch; ``sdnetv2`` takes ``1dcorr``
  or ``2dcorr`` and normalizes both (:183);
* disp2 = 0.8 * d2 + 0.2 * disp1;
* with ``-edges`` the image convs take the four channels of an image and its
  edge map; ``sdnetv2``'s trunk takes the first three, but ``sdnet``'s takes
  all four (the JAX ``DSNet`` hands ``input_a`` to its trunk whole,
  ``sdnet_legacy.py:36-42``), so its ``conv0`` has 4 input channels there.

The trunk runs as ``sdnet.both_views`` says (``sdnet_legacy.py:41-42,
166-167``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..ops.resize import resize_bilinear, upsample_nearest
from ..utils.profiling import span
from .blocks import Conv2DownUp, ConvBN, ConvOut, DeconvBN
from .pyramid import PiramidNetV1
from .sdnet import (
    SegNetHead,
    both_views,
    channels_last,
    corr_patch,
    cost_volume,
    image_channels,
    nchw_channels_last,
    nhwc,
)


def _conv1x1(cin: int, cout: int) -> ConvBN:
    return ConvBN(cin, cout, 1, batchnorm=False, relu=True)


class DSNet(nn.Module):
    """dsnet (dsnet_t2.py:119-321), registered as ``sdnet``."""

    IMAGE_CONVS = ("conv2d_ba1", "conv2d_ba2", "conv2d_ba3")
    TRUNK_TAKES_EDGES = True  # the JAX DSNet's trunk takes input_a whole

    def __init__(self, cfg: ModelConfig, labels: int = 2):
        super().__init__()
        self.patch = self.correlation_patch(cfg)
        img = image_channels(cfg)
        self.features = PiramidNetV1(img if self.TRUNK_TAKES_EDGES else 3)
        c0, c1, _, _, c4, _, c_py0 = self.features.out_channels
        for name in self.IMAGE_CONVS:
            self.add_module(name, ConvBN(img, 1, 5, dilation=2, relu=True))
        self.make_head1(2 * c4, labels)
        self.corrConv2d = _conv1x1(self.patch[0] * self.patch[1], 128)
        self.cdu3 = Conv2DownUp(32, 128, 3)
        self.cdu4 = Conv2DownUp(256, 64, 3)
        # disparity head 1
        self.conv1d_2 = _conv1x1(64 + 1, 64)
        self.cdu5 = Conv2DownUp(64, 64, 5, last_layer=False)
        self.dispoutConv = ConvOut(64, 1, 5)
        # refined seg head
        self.conv1d_3 = _conv1x1(32 + 64, 64)
        self.cdu6 = Conv2DownUp(64, 64, 5)
        self.conv1d_4 = _conv1x1(64 + c1, 64)
        self.deconv_ba1 = DeconvBN(64, 32, 3, stride=2, relu=True)
        self.conv1d_5 = _conv1x1(32 + c0, 32)
        self.deconv_ba2 = DeconvBN(32, 32, 3, stride=2, relu=True)
        self.conv1d_6 = _conv1x1(32 + 1, 32)
        self.cdu7 = Conv2DownUp(32, 32, 5, last_layer=False)
        self.branchConv = ConvOut(32, labels, 5)
        # refined disparity head
        self.conv1d_9 = _conv1x1(2 * c_py0, 128)
        self.cdu8 = Conv2DownUp(32, 64, 3)
        self.cdu9 = Conv2DownUp(64 + 128 + 64, 64, 3)
        self.conv1d_8 = _conv1x1(64 + 1, 64)
        self.cdu10 = Conv2DownUp(64, 64, 5, last_layer=False)
        self.cdu10_out = ConvOut(64, 1, 5)

    @staticmethod
    def correlation_patch(cfg: ModelConfig) -> Tuple[int, int]:
        return (17, 17)

    def make_head1(self, cin: int, labels: int) -> None:
        self.conv1d_1 = _conv1x1(cin, 64)
        self.cdu1 = Conv2DownUp(64, 32, 3)
        self.cdu2 = Conv2DownUp(32, 32, 3, last_layer=False)
        self.cdu2_out = ConvOut(32, labels, 3)

    def head1(self, x, full_hw: Tuple[int, int], left):
        """(x at /16, x1 at /8, seg1 at full resolution)."""
        x = self.cdu1(self.conv1d_1(upsample_nearest(x, 2)))
        x1 = upsample_nearest(x, 2)
        seg1 = upsample_nearest(self.cdu2_out(self.cdu2(x1)), 8)
        return x, x1, F.log_softmax(resize_bilinear(seg1, full_hw), dim=1)

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor, **_) -> Dict[str, torch.Tensor]:
        left = nchw_channels_last(input_a)
        n = input_a.shape[-1] if self.TRUNK_TAKES_EDGES else 3
        with span("model.trunk"):
            a, b = both_views(self.features, nchw_channels_last(input_a[..., :n]),
                              nchw_channels_last(input_b[..., :n]))
        full_hw = tuple(left.shape[-2:])
        a0, a1, a4, a_py2, a_py0 = (a[i] for i in (0, 1, 4, 5, 6))
        b4, b_py2, b_py0 = (b[i] for i in (4, 5, 6))
        xleft3, xleft2, xleft1 = (channels_last(getattr(self, f"conv2d_ba{k}")(left))
                                  for k in (3, 1, 2))

        x, x1, seg1 = self.head1(torch.cat([a4, b4], dim=1), full_hw, left)

        # cost volume at 1/8, normalized by the channel count
        y = self.corrConv2d(cost_volume(a_py2, b_py2, self.patch, True))
        y1 = resize_bilinear(self.cdu3(x1), y.shape[-2:])
        y = self.cdu4(torch.cat([y1, y], dim=1))

        # disparity head 1
        y2 = upsample_nearest(y, 8)
        xl2 = resize_bilinear(xleft2, y2.shape[-2:])
        d = self.dispoutConv(self.cdu5(self.conv1d_2(torch.cat([y2, xl2], dim=1))))
        disp1 = resize_bilinear(d, full_hw)

        # refined seg head (dsnet_t2.py:252-279)
        y3 = upsample_nearest(y, 2)
        xx = resize_bilinear(upsample_nearest(x, 4), y3.shape[-2:])
        xx = self.cdu6(self.conv1d_3(torch.cat([xx, y3], dim=1)))
        xx = resize_bilinear(xx, a1.shape[-2:])
        x3 = self.deconv_ba1(self.conv1d_4(torch.cat([xx, a1], dim=1)))
        xx = resize_bilinear(x3, a0.shape[-2:])
        xx = self.deconv_ba2(self.conv1d_5(torch.cat([xx, a0], dim=1)))
        xl1 = resize_bilinear(xleft1, xx.shape[-2:])
        s2 = self.branchConv(self.cdu7(self.conv1d_6(torch.cat([xx, xl1], dim=1))))
        s2 = resize_bilinear(F.log_softmax(s2, dim=1), full_hw)
        seg2 = 0.9 * s2 + 0.1 * seg1

        # refined disparity head (dsnet_t2.py:283-304)
        y4 = self.conv1d_9(torch.cat([a_py0, b_py0], dim=1))
        yy = resize_bilinear(upsample_nearest(y, 4), y4.shape[-2:])
        yy = torch.cat([y4, yy], dim=1)
        y5 = self.cdu8(x3)
        yy = resize_bilinear(yy, y5.shape[-2:])
        yy = upsample_nearest(self.cdu9(torch.cat([y5, yy], dim=1)), 2)
        xl3 = resize_bilinear(xleft3, yy.shape[-2:])
        d2 = self.cdu10_out(self.cdu10(self.conv1d_8(torch.cat([yy, xl3], dim=1))))
        disp2 = 0.8 * resize_bilinear(d2, full_hw) + 0.2 * disp1

        return {"seg1": nhwc(seg1), "disp1": nhwc(disp1),
                "seg2": nhwc(seg2), "disp2": nhwc(disp2)}


class DSNetV2(DSNet):
    """dsnetv2 (dsnet_t2.py:402-616), registered as ``sdnetv2``: the dsnet
    cascade with the ``segNet`` helper as head 1 (fed by ``conv2d_ba0``) and
    the ``-corrType`` switch."""

    IMAGE_CONVS = DSNet.IMAGE_CONVS + ("conv2d_ba0",)
    TRUNK_TAKES_EDGES = False  # the trunk takes input_a[..., :3] (:159-160)

    @staticmethod
    def correlation_patch(cfg: ModelConfig) -> Tuple[int, int]:
        return corr_patch(cfg)

    def make_head1(self, cin: int, labels: int) -> None:
        self.segNet = SegNetHead(cin, labels)

    def head1(self, x, full_hw: Tuple[int, int], left):
        return self.segNet(x, full_hw, channels_last(self.conv2d_ba0(left)))


@MODELS.register("sdnet")
def _make_dsnet(cfg: ModelConfig, labels: int) -> DSNet:
    return DSNet(cfg, labels=labels)


@MODELS.register("sdnetv2")
def _make_dsnetv2(cfg: ModelConfig, labels: int) -> DSNetV2:
    return DSNetV2(cfg, labels=labels)
