"""The Ext_small family, RCU-based compact joint nets, NCHW inside and NHWC
in and out like the flagship.

Counterpart of the JAX package's ``models/ext_small.py`` (reference
models/dsnet_t2_ext_small.py: RCU :43-64, Ext_small :130-381, Ext_smallv2
:382-638, Ext_smallv0 :639-894, the file-local segNet :1072-1096). The
skeleton of the flagship with RCU residual units in place of the
``Conv2DownUp`` hourglasses (in the seg head too), one self-attention gate
from s2, bias-free conv output heads and trunk-tap skips, on any trunk
(the ResNet trunks add ``aspp_4``), aspp 0/1/2 (aspp 2 with its second,
unnormalized corr1d over the two views' ASPP), either correlation:

* ``sdnet_mini_ext_small`` (v0): RCUs with their stride-1 deconv, head 1
  with ``labels`` classes, skips from a0 and the pyramid's b0;
* ``sdnet_mini_ext_small_edge`` (``edgeOut``): every RCU with a conv in
  place of the deconv; head 1 is one channel, the edge logits; the skips are
  5x5 dilated convs over the left image's gradient magnitude ``left_e`` (a
  keyword input), named crossed as in the JAX model: ``conv2d_ba0`` (head
  1's, at half size), ``conv2d_ba2`` (the final skip, full size) and
  ``conv2d_ba1`` (the disparity head's, half size);
* ``sdnet_mini_ext_small_edgev2`` (``edgeOut``): v0's wiring with head 1 of
  one channel.

The edge variants return ``edge`` = head 1 and ``seg1`` = head 2 (the
reference netForward's mapping for ``edgeOut``). The trunk runs as
``sdnet.both_views`` says; the nets have no dropout.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..ops.resize import resize_bilinear, resize_nearest, upsample_nearest
from .aspp import ASPP
from .blocks import ConvBN, DeconvBN, conv2d
from .pyramid import PiramidNet2
from .sdnet import (
    KERNEL_PATCH_1D,
    both_views,
    corr_patch,
    cost_volume,
    nchw_channels_last,
    nhwc,
)

VARIANTS = ("v0", "edge", "v2")


class RCU(nn.Module):
    """Residual conv unit: c1 -> c2 -> (d3 deconv | c3 conv), each with BN and
    ReLU, plus c1's output."""

    def __init__(self, cin: int, features: int, kernel: int = 3, use_deconv: bool = True):
        super().__init__()
        kw = dict(kernel=kernel, relu=True)
        self.c1 = ConvBN(cin, features, **kw)
        self.c2 = ConvBN(features, features, **kw)
        if use_deconv:
            self.d3 = DeconvBN(features, features, **kw)
        else:
            self.c3 = ConvBN(features, features, **kw)
        self.use_deconv = use_deconv

    def forward(self, x):
        x = self.c1(x)
        y = self.c2(x)
        y = self.d3(y) if self.use_deconv else self.c3(y)
        return y + x


class ExtSmallSegNet(nn.Module):
    """The file-local segNet: RCU-based, a bare bias-free conv output head
(flax ``nn.Conv``'s lecun init, as are ``dispoutConv`` and ``rcu11_out``).
    Returns (x @ deepest/2, x1 @ deepest/4, seg @ full res)."""

    def __init__(self, cin: int, labels: int, skip_channels: int, rcu_deconv: bool = True):
        super().__init__()
        self.conv1d_1 = ConvBN(cin, 64, 1, batchnorm=False, relu=True)
        self.cdu1 = RCU(64, 32, 3, rcu_deconv)
        self.conv1d_2 = ConvBN(32 + skip_channels, 32, 1, batchnorm=False, relu=True)
        self.cdu2 = RCU(32, 32, 3, rcu_deconv)
        self.out = conv2d(32, labels, 3, init="lecun")

    def forward(self, x, full_hw: Tuple[int, int], xleft):
        x = self.cdu1(self.conv1d_1(upsample_nearest(x, 2)))
        x1 = upsample_nearest(x, 2)
        x1_1 = torch.cat([resize_nearest(x, xleft.shape[-2:]), xleft], dim=1)
        seg = self.out(self.cdu2(self.conv1d_2(x1_1)))
        return x, x1, resize_nearest(seg, full_hw)


class ExtSmall(nn.Module):
    """The three Ext_small variants (``variant``: "v0", "edge", "v2")."""

    def __init__(self, cfg: ModelConfig, labels: int = 2, variant: str = "v0"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
        self.variant, self.aspp_mod = variant, cfg.aspp
        self.patch = corr_patch(cfg)
        self.normalize = cfg.corr_type != "1dcorr"
        use_dc = variant != "edge"
        self.features = PiramidNet2(cfg.backbone)
        taps = self.features.out_channels
        c0, c1, c3, c4, c_py2, c_py1, c_py0 = (taps[i] for i in (0, 1, 3, 4, 5, 6, 7))
        # the modules in the JAX model's call order (the seeded init draws in
        # registration order)
        if variant == "edge":
            # over left_e, the gradient magnitude of each of the 3 channels
            for name in ("conv2d_ba0", "conv2d_ba2", "conv2d_ba1"):
                self.add_module(name, ConvBN(3, 1, 5, dilation=2, relu=True))
            seg_skip = disp_skip = final_skip = 1
        else:
            seg_skip, disp_skip, final_skip = c0, c0, c_py0
        if cfg.backbone in ("resnet50", "resnet101"):
            self.aspp_4 = ASPP(c4, output_stride=16)
            c4 = self.aspp_4.out_channels
        head1 = labels if variant == "v0" else 1
        self.segNet = ExtSmallSegNet(2 * c4, head1, seg_skip, use_dc)
        self.corrConv2d = ConvBN(self.patch[0] * self.patch[1], 128, 1, batchnorm=False, relu=True)
        self.rcu3 = RCU(32, 64, 3, use_dc)
        self.rcu4 = RCU(64 + 128, 64, 3, use_dc)
        self.conv1d_2 = ConvBN(64 + disp_skip, 64, 1, batchnorm=False, relu=True)
        self.rcu5 = RCU(64, 64, 5, use_dc)
        self.dispoutConv = conv2d(64, 1, 5, init="lecun")
        if self.aspp_mod == 1:
            self.aspp = ASPP(c1, output_stride=32)
            s2_in = self.aspp.out_channels
        elif self.aspp_mod == 2:
            self.aspp = ASPP(c3, output_stride=32)
            s2_in = KERNEL_PATCH_1D[1] + self.aspp.out_channels
        else:
            s2_in = c_py1  # the right view's pyramid only
        self.conv1d_4 = ConvBN(s2_in, 128, 1, batchnorm=False, relu=True)
        self.rcu6 = RCU(128, 64, 3, use_dc)
        self.rcu7 = RCU(128, 64, 3, use_dc)
        self.rcu8 = RCU(32, 64, 3, use_dc)
        self.rcu9 = RCU(128, 64, 3, use_dc)
        self.conv1d_at = ConvBN(64, 1, 1, batchnorm=False)
        self.rcu10 = RCU(128, 64, 3, use_dc)
        cat_skip = c0 if self.aspp_mod == 2 else final_skip
        self.conv1d_5 = ConvBN(64 + cat_skip, 32, 1, batchnorm=False, relu=True)
        self.rcu11 = RCU(32, 32, 3, use_dc)
        self.rcu11_out = conv2d(32, labels, 3, init="lecun")

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor,
                left_e: Optional[torch.Tensor] = None, **_) -> Dict[str, torch.Tensor]:
        left, right = nchw_channels_last(input_a[..., :3]), nchw_channels_last(input_b[..., :3])
        full_hw = tuple(left.shape[-2:])
        a, b = both_views(self.features, left, right)
        a0, a1, a3, a4, a_py2, a_py0 = (a[i] for i in (0, 1, 3, 4, 5, 7))
        b3, b4, b_py2, b_py1 = (b[i] for i in (3, 4, 5, 6))

        if self.variant == "edge":
            if left_e is None:
                raise ValueError("the edge variant takes the edge map left_e")
            edge = nchw_channels_last(left_e)
            half = (edge.shape[-2] // 2, edge.shape[-1] // 2)
            edge_half = resize_bilinear(edge, half)
            seg_skip = self.conv2d_ba0(edge_half)
            final_skip = self.conv2d_ba2(edge)
            disp_skip = self.conv2d_ba1(edge_half)
        else:
            seg_skip = disp_skip = a0
            final_skip = a_py0
        if hasattr(self, "aspp_4"):
            a4, b4 = both_views(self.aspp_4, a4, b4)

        x, x1, seg_branch = self.segNet(torch.cat([a4, b4], dim=1), full_hw, seg_skip)

        y = self.corrConv2d(cost_volume(a_py2, b_py2, self.patch, self.normalize))
        y1 = resize_bilinear(self.rcu3(x1), y.shape[-2:])
        y = self.rcu4(torch.cat([y1, y], dim=1))

        y2 = upsample_nearest(y, 8)
        dskip = resize_bilinear(disp_skip, y2.shape[-2:])
        disp = self.rcu5(self.conv1d_2(torch.cat([y2, dskip], dim=1)))
        disp_out = resize_bilinear(self.dispoutConv(disp), full_hw)

        if self.aspp_mod == 1:
            s2 = self.aspp(a1)
        elif self.aspp_mod == 2:
            s2_1, s2_2 = self.aspp(a3), self.aspp(b3)
            s2 = torch.cat([cost_volume(s2_1, s2_2, KERNEL_PATCH_1D, False), s2_1], dim=1)
        else:
            s2 = b_py1
        s2 = self.rcu6(self.conv1d_4(s2))
        s2_hw = s2.shape[-2:]
        y3 = resize_nearest(y, s2_hw)
        s2_d = self.rcu7(torch.cat([s2, y3], dim=1))
        x3 = resize_nearest(self.rcu8(x1), s2_hw)
        s2_s = self.rcu9(torch.cat([s2, x3], dim=1))
        s2_at = torch.sigmoid(self.conv1d_at(s2))
        s2 = self.rcu10(torch.cat([s2_d * s2_at, s2_s * (1.0 - s2_at)], dim=1))

        cat_skip = a0 if self.aspp_mod == 2 else final_skip
        s2 = torch.cat([resize_nearest(s2, cat_skip.shape[-2:]), cat_skip], dim=1)
        sb2 = self.rcu11_out(self.rcu11(self.conv1d_5(s2)))
        seg_branch2 = resize_nearest(sb2, full_hw)

        out = {"seg1": nhwc(seg_branch), "disp1": nhwc(disp_out),
               "seg2": nhwc(seg_branch2), "disp2": nhwc(disp_out)}
        if self.variant != "v0":
            # edgeOut: head 1 is the edge logits, head 2 the segmentation
            out["edge"], out["seg1"] = out["seg1"], out["seg2"]
        return out


@MODELS.register("sdnet_mini_ext_small")
def _make_v0(cfg: ModelConfig, labels: int) -> ExtSmall:
    return ExtSmall(cfg, labels=labels, variant="v0")


@MODELS.register("sdnet_mini_ext_small_edge")
def _make_edge(cfg: ModelConfig, labels: int) -> ExtSmall:
    return ExtSmall(cfg, labels=labels, variant="edge")


@MODELS.register("sdnet_mini_ext_small_edgev2")
def _make_edgev2(cfg: ModelConfig, labels: int) -> ExtSmall:
    return ExtSmall(cfg, labels=labels, variant="v2")
