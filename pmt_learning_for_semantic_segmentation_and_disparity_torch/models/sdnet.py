"""The SDNet models of the JAX package's ``models/sdnet.py``: the flagship
``sdnet_mini_ext`` (MiniDSNetExt) and ``sdnet_mini`` (MiniDSNet), eval and
train forward.

Counterpart of the JAX package's ``models/sdnet.py`` for the flagship variant
"ext" with aspp 0, the cross-task attention gates and either correlation
(``1dcorr``: the 1-D (1, 17) patch; ``2dcorr``: the 17x17 patch, normalized
by the channel count), on its plain (non space-to-depth) path, which computes
the same function as the JAX package's s2d heads. The public forward keeps
the JAX layout: NHWC images in, a dict of NHWC outputs (seg1, disp1, seg2,
disp2). Inside, the modules run in NCHW with channels_last memory, so the
NHWC views that the correlation kernels take and return cost no copy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..ops.correlation import correlation
from ..ops.resize import resize_bilinear, resize_nearest, upsample_nearest
from .blocks import Conv2DownUp, ConvBN, ConvOut
from .pyramid import PiramidNet2, PiramidNetV1


def corr_patch(m: ModelConfig) -> Tuple[int, int]:
    """The correlation patch of ``-corrType``, as the JAX models choose it."""
    return (1, 17) if m.corr_type == "1dcorr" else (17, 17)


def trunk_taps(features: nn.Module, left: torch.Tensor, right: torch.Tensor):
    """The trunk's taps of each view, (left's, right's). In train mode the
    trunk runs once per view, left then right, as in the JAX package, so each
    view normalises by its own batch statistics and the running statistics
    move twice in that order. In eval mode one pass over L and R stacked in
    the batch computes the same as two."""
    if features.training:
        return features(left), features(right)
    nb = left.shape[0]
    both = features(torch.cat([left, right], dim=0))
    return [t[:nb] for t in both], [t[nb:] for t in both]


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def nchw_channels_last(t: torch.Tensor) -> torch.Tensor:
    """An NHWC input as the NCHW channels_last tensor the modules take."""
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def cost_volume(a: torch.Tensor, b: torch.Tensor, patch: Tuple[int, int],
                normalize: bool) -> torch.Tensor:
    """The correlation of two NCHW feature maps, as NCHW (B, ph*pw, H, W);
    the NHWC views in and out are free for channels_last tensors."""
    return correlation(nhwc(a).contiguous(), nhwc(b).contiguous(), patch,
                       normalize=normalize).permute(0, 3, 1, 2)


class SegNetHead(nn.Module):
    """segNet (dsnet_t2.py:915-938): coarse seg decoder over cat(a4, b4).

    Returns (x @ deepest/2, x1 @ deepest/4, seg logits @ full res)."""

    def __init__(self, cin: int, labels: int, dropout: float = 0.0):
        super().__init__()
        self.conv1d_1 = ConvBN(cin, 64, 1, batchnorm=False, relu=True)
        self.cdu1 = Conv2DownUp(64, 32, 3, dropout=dropout)
        self.conv1d_2 = ConvBN(32 + 1, 32, 1, batchnorm=False, relu=True)
        self.cdu2 = Conv2DownUp(32, 32, 3, last_layer=False, dropout=dropout)
        self.out = ConvOut(32, labels, 3)

    def forward(self, x, full_hw: Tuple[int, int], xleft):
        x = self.cdu1(self.conv1d_1(upsample_nearest(x, 2)))
        x1 = upsample_nearest(x, 2)
        x1_1 = torch.cat([resize_nearest(x, xleft.shape[-2:]), xleft], dim=1)
        seg = self.out(self.cdu2(self.conv1d_2(x1_1)))
        return x, x1, resize_nearest(seg, full_hw)


def _unported(m: ModelConfig) -> str:
    if m.backbone != "densenet":
        return f"backbone {m.backbone!r} (ROADMAP.md queue 1, item 12.6)"
    if m.aspp:
        return f"aspp {m.aspp} (ROADMAP.md queue 1, item 12.3)"
    if m.hanet:
        return "hanet (ROADMAP.md queue 1, item 12.4)"
    if m.multaskloss:
        return f"multaskloss {m.multaskloss} (ROADMAP.md queue 1, item 12.7)"
    if m.conv_deconv_out:
        return f"convDeconvOut {m.conv_deconv_out} (ROADMAP.md queue 1, item 12.2)"
    if m.edges:
        return "edges (ROADMAP.md queue 1, item 12.7)"
    if m.ablation:
        return f"ablation {m.ablation} (ROADMAP.md queue 1, item 12.2)"
    if not m.use_att:
        return "use_att=False (ROADMAP.md queue 1, item 12.2)"
    return ""


class MiniDSNetExt(nn.Module):
    """minidsnetExt (dsnet_t2.py:941-1299), variant "ext", aspp 0, attention
    gates on, 1dcorr or 2dcorr (normalized, as ``sdnet.py:206-208``).

    The trunk runs as ``trunk_taps`` says (``sdnet.py:147-151``); in train
    mode dropout follows ``cfg.dropout``."""

    def __init__(self, cfg: ModelConfig, labels: int = 2):
        super().__init__()
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(f"sdnet_mini_ext with {missing} is not ported yet")
        d = self.dropout = cfg.dropout
        self.patch = corr_patch(cfg)
        self.normalize = cfg.corr_type != "1dcorr"
        self.features = PiramidNet2(cfg.backbone)
        taps = self.features.out_channels
        c4, c_py1 = taps[4], taps[6]
        # 5x5 dilation-2 image conv, 3 -> 4 channels (the JAX package's merge
        # of the reference's four 3 -> 1 convs; channel 3 is unused)
        self.conv2d_ba = ConvBN(3, 4, 5, dilation=2, relu=True)
        self.segNet = SegNetHead(2 * c4, labels, dropout=d)
        self.corrConv2d = ConvBN(self.patch[0] * self.patch[1], 128, 1, batchnorm=False,
                                 relu=True)
        self.cdu3 = Conv2DownUp(32, 128, 3, dropout=d)
        self.cdu4 = Conv2DownUp(256, 64, 3, dropout=d)
        self.conv1d_2 = ConvBN(64 + 1, 64, 1, batchnorm=False, relu=True)
        self.cdu5 = Conv2DownUp(64, 64, 5, last_layer=False, dropout=d)
        self.dispoutConv = ConvOut(64, 1, 5)
        self.conv1d_4 = ConvBN(2 * c_py1, 128, 1, batchnorm=False, relu=True)
        self.cdu6 = Conv2DownUp(128, 64, 3, dropout=d)
        self.cdu7 = Conv2DownUp(128, 64, 3, dropout=d)
        self.conv1d_at_d = ConvBN(64, 1, 1, batchnorm=False)
        self.cdu8 = Conv2DownUp(32, 64, 3, dropout=d)
        self.cdu9 = Conv2DownUp(128, 64, 3, dropout=d)
        self.conv1d_at_s = ConvBN(64, 1, 1, batchnorm=False)
        self.cdu10 = Conv2DownUp(128, 64, 3, dropout=d)
        self.conv1d_5 = ConvBN(64 + 1, 32, 1, batchnorm=False, relu=True)
        self.cdu11 = Conv2DownUp(32, 32, 3, last_layer=False, dropout=d)
        self.cdu11_out = ConvOut(32, labels, 3)

    def gate_dropout(self, t: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout > 0:
            return F.dropout(t, self.dropout)
        return t

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor) -> Dict[str, torch.Tensor]:
        left, right = nchw_channels_last(input_a), nchw_channels_last(input_b)
        full_hw = tuple(left.shape[-2:])

        # the net reads tap 4 and the enriched taps b2, b1 (indices 4, 5, 6)
        a, b = trunk_taps(self.features, left, right)
        a4, a_py2, a_py1 = (a[i] for i in (4, 5, 6))
        b4, b_py2, b_py1 = (b[i] for i in (4, 5, 6))

        xleft_all = self.conv2d_ba(left)
        xleft0, xleft1, xleft2 = xleft_all[:, 0:1], xleft_all[:, 1:2], xleft_all[:, 2:3]

        # head 1: coarse seg decoder on the concatenated deepest features
        x, x1, seg_branch = self.segNet(torch.cat([a4, b4], dim=1), full_hw, xleft0)

        # cost volume at 1/8 on the pyramid-enriched tap 2
        y = self.corrConv2d(cost_volume(a_py2, b_py2, self.patch, self.normalize))
        y1 = resize_bilinear(self.cdu3(x1), y.shape[-2:])
        y = self.cdu4(torch.cat([y1, y], dim=1))

        # disparity head at full resolution
        y2 = upsample_nearest(y, 8)
        xl2 = resize_bilinear(xleft2, y2.shape[-2:])
        disp = self.conv1d_2(torch.cat([y2, xl2], dim=1))
        disp = self.dispoutConv(self.cdu5(disp))
        disp_out = resize_bilinear(disp, full_hw)

        # head 2 (aspp 0): pyramid tap 1 of both views, crossed attention gates
        s2 = self.cdu6(self.conv1d_4(torch.cat([a_py1, b_py1], dim=1)))
        s2_hw = s2.shape[-2:]
        y3 = resize_nearest(y, s2_hw)
        s2_d = self.cdu7(torch.cat([s2, y3], dim=1))
        at_d = self.gate_dropout(torch.sigmoid(self.conv1d_at_d(s2_d)))
        x3 = resize_nearest(self.cdu8(x1), s2_hw)
        s2_s = self.cdu9(torch.cat([s2, x3], dim=1))
        at_s = self.gate_dropout(torch.sigmoid(self.conv1d_at_s(s2_s)))
        s2 = self.cdu10(torch.cat([s2_d * at_s, s2_s * at_d], dim=1))

        s2 = torch.cat([resize_nearest(s2, xleft1.shape[-2:]), xleft1], dim=1)
        seg_branch2 = self.cdu11_out(self.cdu11(self.conv1d_5(s2)))

        return {"seg1": nhwc(seg_branch), "disp1": nhwc(disp_out),
                "seg2": nhwc(seg_branch2), "disp2": nhwc(disp_out)}


class MiniDSNet(nn.Module):
    """minidsnet (dsnet_t2.py:825-912), registered as ``sdnet_mini``: one seg
    and one disparity head, outputs duplicated (seg2 = seg1, disp2 = disp1),
    on the original piramidNet (``PiramidNetV1``), 1dcorr or 2dcorr (the
    latter normalized). The trunk runs as ``trunk_taps`` says
    (``sdnet.py:453-454``); the net has no dropout."""

    def __init__(self, cfg: ModelConfig, labels: int = 2):
        super().__init__()
        if cfg.edges:
            raise NotImplementedError("sdnet_mini with edges is not ported yet "
                                      "(ROADMAP.md queue 1, item 12.7)")
        self.patch = corr_patch(cfg)
        self.normalize = cfg.corr_type != "1dcorr"
        self.features = PiramidNetV1()
        taps = self.features.out_channels
        # the JAX package's merge of the reference's image convs: channel 0
        # feeds the seg head, channel 1 the disparity head
        self.conv2d_ba = ConvBN(3, 2, 5, dilation=2, relu=True)
        self.segNet = SegNetHead(2 * taps[4], labels)
        self.corrConv2d = ConvBN(self.patch[0] * self.patch[1], 128, 1, batchnorm=False,
                                 relu=True)
        self.cdu3 = Conv2DownUp(32, 128, 3)
        self.cdu4 = Conv2DownUp(256, 64, 3)
        self.conv1d_2 = ConvBN(64 + 1, 64, 1, batchnorm=False, relu=True)
        self.cdu5 = Conv2DownUp(64, 64, 5, last_layer=False)
        self.dispoutConv = ConvOut(64, 1, 5)

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor) -> Dict[str, torch.Tensor]:
        left, right = nchw_channels_last(input_a), nchw_channels_last(input_b)
        full_hw = tuple(left.shape[-2:])
        a, b = trunk_taps(self.features, left, right)
        a4, a_py2 = a[4], a[5]
        b4, b_py2 = b[4], b[5]

        xleft_all = self.conv2d_ba(left)
        x, x1, seg_branch = self.segNet(torch.cat([a4, b4], dim=1), full_hw, xleft_all[:, 0:1])

        y = self.corrConv2d(cost_volume(a_py2, b_py2, self.patch, self.normalize))
        y1 = resize_bilinear(self.cdu3(x1), y.shape[-2:])
        y = self.cdu4(torch.cat([y1, y], dim=1))

        y2 = upsample_nearest(y, 8)
        xl2 = resize_bilinear(xleft_all[:, 1:2], y2.shape[-2:])
        disp = self.dispoutConv(self.cdu5(self.conv1d_2(torch.cat([y2, xl2], dim=1))))
        disp_out = resize_bilinear(disp, full_hw)
        return {"seg1": nhwc(seg_branch), "disp1": nhwc(disp_out),
                "seg2": nhwc(seg_branch), "disp2": nhwc(disp_out)}


@MODELS.register("sdnet_mini_ext")
def _make_ext(cfg: ModelConfig, labels: int) -> MiniDSNetExt:
    return MiniDSNetExt(cfg, labels=labels)


@MODELS.register("sdnet_mini")
def _make_mini(cfg: ModelConfig, labels: int) -> MiniDSNet:
    return MiniDSNet(cfg, labels=labels)
