"""minidsnetExt_deeplab (``sdnet_mini_ext_dlab``): the flagship's skeleton on
a HANet-style deeplabV3plus ResNet-101, NCHW inside and NHWC in and out.

Counterpart of the JAX package's ``models/sdnet_dlab.py`` (reference
models/dsnet_t2.py:2426-2729 and models_hanet/resnet_pytorch.py:70-232).
The trunk is the dilated ResNet-101 at output stride 8 with HANet's 3x3x3
stem and uniform dilation (``ResNetDeeplabFeatures(stem="3x3x3",
multigrid=False)``); its return layers (dec0_up 256@/8, layer 3 1024@/8,
layer 2 512@/8, dec0_fine 48@/4) are consumed as (a4, py2, py1, py0), so
the correlation runs over layer 3's 1024 channels. Head 1 is the flagship's
``SegNetHead`` over the left view's dec0_up alone, with dec0_fine as its
skip; the cross-task gates are always on unless ``no_dec3``;
``convDeconvOut`` resizes to full resolution before its output convs;
HANet (``-hanet``) reads dec0_fine. The net has no dropout.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..ops.resize import resize_bilinear, resize_bilinear_align_corners, resize_nearest, upsample_nearest
from .blocks import Conv2DownUp, ConvBN, ConvOut, batch_norm, conv2d
from .hanet import HANetConv
from .resnet_deeplab import ResNetDeeplabFeatures
from .sdnet import SegNetHead, both_views, corr_patch, cost_volume, nchw_channels_last, nhwc

RATES = (12, 24, 36)  # HANet's ASPP at output stride 8


class HANetASPP(nn.Module):
    """HANet's _AtrousSpatialPyramidPoolingModule at output stride 8: image
    pooling FIRST, then 1x1 and the 3x3 branches at rates 12/24/36, each with
    BN and ReLU, concatenated (5 x 256 channels) with no projection (the net's
    ``bot_aspp`` projects). The pooled branch is broadcast back
    (align_corners bilinear from 1x1)."""

    def __init__(self, cin: int, features: int = 256):
        super().__init__()
        self.img_conv = conv2d(cin, 256, 1, init="kaiming")
        self.img_bn = batch_norm(256)
        self.feat0_conv = conv2d(cin, features, 1, init="kaiming")
        self.feat0_bn = batch_norm(features)
        for i, r in enumerate(RATES, start=1):
            self.add_module(f"feat{i}_conv", conv2d(cin, features, 3, dilation=r, init="kaiming"))
            self.add_module(f"feat{i}_bn", batch_norm(features))
        self.out_channels = 256 + 4 * features

    def forward(self, x):
        img = F.relu(self.img_bn(self.img_conv(x.mean(dim=(2, 3), keepdim=True))))
        outs = [resize_bilinear_align_corners(img, x.shape[-2:])]
        for i in range(len(RATES) + 1):
            outs.append(F.relu(getattr(self, f"feat{i}_bn")(getattr(self, f"feat{i}_conv")(x))))
        return torch.cat(outs, dim=1)


class DeeplabV3PlusFeatures(nn.Module):
    """deeplabV3plus(return_layers=True): the trunk, HANet's ASPP and the
    1x1 ``bot_aspp``/``bot_fine`` projections; returns (dec0_up 256@/8,
    layer 3 1024@/8, layer 2 512@/8, dec0_fine 48@/4)."""

    def __init__(self, layers=(3, 4, 23, 3)):
        super().__init__()
        self.trunk = ResNetDeeplabFeatures(layers, output_stride=8, stem="3x3x3", multigrid=False)
        taps = self.trunk.tap_channels
        self.aspp = HANetASPP(taps[4])
        self.bot_aspp = ConvBN(self.aspp.out_channels, 256, 1, relu=True)
        self.bot_fine = ConvBN(taps[1], 48, 1, relu=True)
        self.out_channels = (256, taps[3], taps[2], 48)

    def forward(self, x):
        _, low, middle, high, final = self.trunk(x)
        return (self.bot_aspp(self.aspp(final)), high, middle, self.bot_fine(low))


class MiniDSNetExtDeeplab(nn.Module):
    """``sdnet_mini_ext_dlab`` with ``no_dec1``/``no_dec3``, convDeconvOut 1/2,
    HANet, either correlation and ``-edges`` (the trunk takes the first three
    channels). The forward takes HANet's ``pos`` as a keyword input."""

    def __init__(self, cfg: ModelConfig, labels: int = 2):
        super().__init__()
        ablation = cfg.ablation or ()
        self.no_dec1, self.no_dec3 = "no_dec1" in ablation, "no_dec3" in ablation
        self.conv_deconv_out, self.hanet = cfg.conv_deconv_out, cfg.hanet
        self.patch = corr_patch(cfg)
        self.normalize = cfg.corr_type != "1dcorr"
        self.features = DeeplabV3PlusFeatures()
        c4, c_py2, c_py1, c_py0 = self.features.out_channels
        self.segNet = SegNetHead(c4, labels, skip_channels=c_py0)
        self.corrConv2d = ConvBN(self.patch[0] * self.patch[1], 128, 1, batchnorm=False, relu=True)
        self.cdu3 = Conv2DownUp(c_py2 if self.no_dec1 else 32, 128, 3)
        self.cdu4 = Conv2DownUp(256, 64, 3)
        self.conv1d_2 = ConvBN(64 + c_py0, 64, 1, batchnorm=False, relu=True)
        self.cdu5 = Conv2DownUp(64, 64, 5, last_layer=False)
        self.dispoutConv = ConvOut(64, 1, 5)
        self.conv1d_4 = ConvBN(c_py1, 128, 1, batchnorm=False, relu=True)
        self.cdu6 = Conv2DownUp(128, 64, 3)
        cdu10_in = 64
        if not self.no_dec3:
            self.cdu7 = Conv2DownUp(128, 64, 3)
            self.conv1d_at_d = ConvBN(64, 1, 1, batchnorm=False)
            self.cdu8 = Conv2DownUp(32, 64, 3)
            self.cdu9 = Conv2DownUp(128, 64, 3)
            self.conv1d_at_s = ConvBN(64, 1, 1, batchnorm=False)
            cdu10_in = 128
        self.cdu10 = Conv2DownUp(cdu10_in, 64, 3)
        self.conv1d_5 = ConvBN(64 + c_py0, 32, 1, batchnorm=False, relu=True)
        self.cdu11 = Conv2DownUp(32, 32, 3, last_layer=False)
        if self.conv_deconv_out:
            # flax nn.Conv's default init (lecun), as the JAX model builds it
            self.convOutput2 = conv2d(32, labels, 3, init="lecun")
            if self.conv_deconv_out == 2:
                self.convOutput = ConvOut(32, labels, 3)
        else:
            self.cdu11_out = ConvOut(32, labels, 3)
        if self.hanet:
            self.hanet_last = HANetConv(c_py0, labels, dropout_prob=0.1,
                                        is_encoding=cfg.hanet_is_encoding,
                                        pos_noise=cfg.hanet_pos_noise)

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor, pos=None,
                **_) -> Dict[str, torch.Tensor]:
        left, right = nchw_channels_last(input_a[..., :3]), nchw_channels_last(input_b[..., :3])
        full_hw = tuple(left.shape[-2:])
        (a4, a_py2, a_py1, a_py0), (_, b_py2, _, _) = both_views(self.features, left, right)

        x, x1, seg_branch = self.segNet(a4, full_hw, a_py0)

        y = self.corrConv2d(cost_volume(a_py2, b_py2, self.patch, self.normalize))
        y1 = resize_bilinear(self.cdu3(a_py2 if self.no_dec1 else x1), y.shape[-2:])
        y = self.cdu4(torch.cat([y1, y], dim=1))

        y2 = upsample_nearest(y, 8)
        xl2 = resize_bilinear(a_py0, y2.shape[-2:])
        disp = self.dispoutConv(self.cdu5(self.conv1d_2(torch.cat([y2, xl2], dim=1))))
        disp_out = resize_bilinear(disp, full_hw)

        s2 = self.cdu6(self.conv1d_4(a_py1))
        s2_hw = s2.shape[-2:]
        y3 = resize_nearest(y, s2_hw)
        if not self.no_dec3:
            s2_d = self.cdu7(torch.cat([s2, y3], dim=1))
            at_d = torch.sigmoid(self.conv1d_at_d(s2_d))
            x3 = resize_nearest(self.cdu8(x1), s2_hw)
            s2_s = self.cdu9(torch.cat([s2, x3], dim=1))
            at_s = torch.sigmoid(self.conv1d_at_s(s2_s))
            s2 = torch.cat([s2_d * at_s, s2_s * at_d], dim=1)
        s2 = self.cdu10(s2)

        s2 = torch.cat([resize_nearest(s2, a_py0.shape[-2:]), a_py0], dim=1)
        sb2 = self.cdu11(self.conv1d_5(s2))
        if self.conv_deconv_out:
            sb2_up = resize_nearest(sb2, full_hw)
            seg_branch2 = self.convOutput2(sb2_up)
            if self.conv_deconv_out == 2:
                seg_branch2 = self.convOutput(sb2_up) + seg_branch2
        else:
            seg_branch2 = resize_nearest(self.cdu11_out(sb2), full_hw)
        if self.hanet:
            seg_branch2, _ = self.hanet_last(a_py0, seg_branch2, pos)

        return {"seg1": nhwc(seg_branch), "disp1": nhwc(disp_out),
                "seg2": nhwc(seg_branch2), "disp2": nhwc(disp_out)}


@MODELS.register("sdnet_mini_ext_dlab")
def _make_ext_dlab(cfg: ModelConfig, labels: int) -> MiniDSNetExtDeeplab:
    return MiniDSNetExtDeeplab(cfg, labels=labels)
