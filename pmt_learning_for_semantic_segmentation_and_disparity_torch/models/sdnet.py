"""The SDNet models of the JAX package's ``models/sdnet.py``: the flagship
family (MiniDSNetExt: ``sdnet_mini_ext``, ``_v2``, ``_piramid``,
``_piramid_res``, with every option of the JAX model on every registered
trunk) and ``sdnet_mini`` (MiniDSNet), eval and train forward.

``-edges`` (``cfg.edges``): the images carry a fourth channel, the sobel
edge map. The trunk takes the first three; the image conv ``conv2d_ba``
takes all four (``sdnet.py:141-142, 181-186``).

Either correlation (``1dcorr``: the 1-D (1, 17) patch; ``2dcorr``: the 17x17
patch, normalized by the channel count) runs on the plain (non
space-to-depth) path, which computes the same function as the JAX package's
s2d heads. The public forward keeps the JAX layout: NHWC images in, a dict
of NHWC outputs (seg1, disp1, seg2, disp2, and the multitask terms mt).
Inside, the modules run in NCHW with channels_last memory, so the NHWC views
that the correlation kernels take and return cost no copy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..losses.multitask import multitask_loss
from ..ops.correlation import correlation
from ..ops.resize import resize_bilinear, resize_nearest, upsample_nearest
from .aspp import ASPP
from .blocks import Conv2DownUp, ConvBN, ConvOut, conv2d
from .hanet import HANetConv
from .pyramid import PiramidNet2, PiramidNetV1

# aspp 2's second correlation: 1-D, unnormalized, whatever -corrType says
KERNEL_PATCH_1D = (1, 17)


def corr_patch(m: ModelConfig) -> Tuple[int, int]:
    """The correlation patch of ``-corrType``, as the JAX models choose it."""
    return (1, 17) if m.corr_type == "1dcorr" else (17, 17)


def image_channels(m: ModelConfig) -> int:
    """The channels of an input image: 3, and the edge map's under -edges."""
    return 4 if m.edges else 3


def both_views(module: nn.Module, a: torch.Tensor, b: torch.Tensor):
    """``module`` over each view, (a's, b's): a trunk over the two images,
    an ASPP over their maps. In train mode it runs once per view, a then b,
    as in the JAX package, so each view normalises by its own batch
    statistics and the running statistics move twice in that order. In eval
    mode one pass over both stacked in the batch computes the same as two.
    The module returns a tensor or a sequence of them (a trunk's taps)."""
    if module.training:
        return module(a), module(b)
    n = a.shape[0]
    out = module(torch.cat([a, b], dim=0))
    if isinstance(out, torch.Tensor):
        return out[:n], out[n:]
    return [t[:n] for t in out], [t[n:] for t in out]


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def nchw_channels_last(t: torch.Tensor) -> torch.Tensor:
    """An NHWC input as the NCHW channels_last tensor the modules take."""
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def channels_last(t: torch.Tensor) -> torch.Tensor:
    """A 1-channel map with channels_last strides. BatchNorm may return NCHW
    strides for C = 1 (both layouts fit one channel), and a ``cat`` with such
    a map, and every layer after it, would then run in NCHW."""
    return torch.empty_like(t, memory_format=torch.channels_last).copy_(t)


def cost_volume(a: torch.Tensor, b: torch.Tensor, patch: Tuple[int, int],
                normalize: bool) -> torch.Tensor:
    """The correlation of two NCHW feature maps, as NCHW (B, ph*pw, H, W);
    the NHWC views in and out are free for channels_last tensors."""
    return correlation(nhwc(a).contiguous(), nhwc(b).contiguous(), patch,
                       normalize=normalize).permute(0, 3, 1, 2)


class SegNetHead(nn.Module):
    """segNet (dsnet_t2.py:915-938): coarse seg decoder over cat(a4, b4).

    Returns (x @ deepest/2, x1 @ deepest/4, seg logits @ full res)."""

    def __init__(self, cin: int, labels: int, dropout: float = 0.0, skip_channels: int = 1):
        super().__init__()
        self.conv1d_1 = ConvBN(cin, 64, 1, batchnorm=False, relu=True)
        self.cdu1 = Conv2DownUp(64, 32, 3, dropout=dropout)
        self.conv1d_2 = ConvBN(32 + skip_channels, 32, 1, batchnorm=False, relu=True)
        self.cdu2 = Conv2DownUp(32, 32, 3, last_layer=False, dropout=dropout)
        self.out = ConvOut(32, labels, 3)

    def forward(self, x, full_hw: Tuple[int, int], xleft):
        x = self.cdu1(self.conv1d_1(upsample_nearest(x, 2)))
        x1 = upsample_nearest(x, 2)
        x1_1 = torch.cat([resize_nearest(x, xleft.shape[-2:]), xleft], dim=1)
        seg = self.out(self.cdu2(self.conv1d_2(x1_1)))
        return x, x1, resize_nearest(seg, full_hw)


# the variants of the flagship family: "ext" (minidsnetExt), "v2"
# (minidsnetExt2: one self-gate, dsnet_t2.py:1888-1891), "piramid"
# (ExtPiramid: the pyramid's /2 map as the final skip, :1547-1559) and
# "piramid_res" (ExtPiramidRes: residual corr fusion, additive gates, a 64-ch
# final Conv2DownUp, :2340-2392)
VARIANTS = ("ext", "v2", "piramid", "piramid_res")


class MiniDSNetExt(nn.Module):
    """minidsnetExt (dsnet_t2.py:941-1299) and its variants on any trunk
    (the ResNet trunks add ``aspp_4``, one ASPP at output stride 16 over both
    views' tap 4, ``sdnet.py:191-196``), with ``-edges``; aspp 0/1/2, the cross-task attention gates on or off (``use_att``), the
    ``no_dec1``/``no_dec3`` ablations, ``convDeconvOut`` 1/2, HANet on the
    head-2 logits and the Kendall multitask modes 1/2, with either
    correlation (2dcorr normalized, as ``sdnet.py:206-208``).

    The trunk runs as ``both_views`` says (``sdnet.py:147-151``); in train
    mode dropout follows ``cfg.dropout`` (ASPP's is its own 0.5). The
    forward takes the JAX model's keyword inputs: ``pos`` (HANet's grids,
    ``hanet.build_pos_grid``), and ``disp_gt`` and ``seg_labels`` (the
    multitask terms ``mt``, computed when both are given)."""

    def __init__(self, cfg: ModelConfig, labels: int = 2, variant: str = "ext"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
        d = self.dropout = cfg.dropout
        self.variant, self.aspp_mod, self.multaskloss = variant, cfg.aspp, cfg.multaskloss
        self.use_att, self.hanet = cfg.use_att, cfg.hanet
        self.conv_deconv_out = cfg.conv_deconv_out
        ablation = cfg.ablation or ()
        self.no_dec1, self.no_dec3 = "no_dec1" in ablation, "no_dec3" in ablation
        self.patch = corr_patch(cfg)
        self.normalize = cfg.corr_type != "1dcorr"
        self.features = PiramidNet2(cfg.backbone)
        taps = self.features.out_channels
        c0, c1, c3, c4, c_py2, c_py1, c_py0 = (taps[i] for i in (0, 1, 3, 4, 5, 6, 7))
        if self.multaskloss == 2:
            # the decoder-only Kendall mode (dsnet_t2.py:1162-1168)
            self.mt_disp_c1 = ConvBN(c4, 256, 1, relu=True)
            self.mt_disp_c2 = conv2d(256, 1, 3, init="lecun")
            self.mt_seg_c1 = ConvBN(c4, 256, 1, relu=True)
            self.mt_seg_c2 = conv2d(256, labels, 3, init="lecun")
            self.log_var_disp = nn.Parameter(torch.zeros(1))
            self.log_var_seg1 = nn.Parameter(torch.zeros(1))
            return
        # 5x5 dilation-2 image conv, 3 (4 with -edges) -> 4 channels (the JAX
        # package's merge of the reference's four 3 -> 1 convs; channel 3 is
        # unused)
        self.conv2d_ba = ConvBN(image_channels(cfg), 4, 5, dilation=2, relu=True)
        if cfg.backbone in ("resnet50", "resnet101"):
            self.aspp_4 = ASPP(c4, output_stride=16)
            c4 = self.aspp_4.out_channels
        self.segNet = SegNetHead(2 * c4, labels, dropout=d)
        ncorr = self.patch[0] * self.patch[1]
        if variant == "piramid_res":
            self.corrConv2d = ConvBN(ncorr, c_py2, 1, batchnorm=False, relu=True)
            self.cdu3 = Conv2DownUp(32, c_py2, 3, dropout=d)
            cdu4_in = c_py2
        else:
            self.corrConv2d = ConvBN(ncorr, 128, 1, batchnorm=False, relu=True)
            self.cdu3 = Conv2DownUp(c_py2 if self.no_dec1 else 32, 128, 3, dropout=d)
            cdu4_in = 256
        self.cdu4 = Conv2DownUp(cdu4_in, 64, 3, dropout=d)
        self.conv1d_2 = ConvBN(64 + 1, 64, 1, batchnorm=False, relu=True)
        self.cdu5 = Conv2DownUp(64, 64, 5, last_layer=False, dropout=d)
        self.dispoutConv = ConvOut(64, 1, 5)

        # head 2's features by aspp mode (dsnet_t2.py:1226-1237)
        if self.aspp_mod == 1:
            self.aspp = ASPP(c1, output_stride=32)
            s2_in = self.aspp.out_channels
        elif self.aspp_mod == 2:
            self.aspp = ASPP(c3, output_stride=32)
            s2_in = KERNEL_PATCH_1D[1] + self.aspp.out_channels
        else:
            s2_in = 2 * c_py1
        self.conv1d_4 = ConvBN(s2_in, 128, 1, batchnorm=False, relu=True)
        self.cdu6 = Conv2DownUp(128, 64, 3, dropout=d)
        # the gates in the JAX model's call order (the seeded init draws in
        # registration order)
        cdu10_in = 64
        if not self.no_dec3 and variant == "v2":
            self.cdu7 = Conv2DownUp(128, 64, 3, dropout=d)
            self.cdu8 = Conv2DownUp(32, 64, 3, dropout=d)
            self.cdu9 = Conv2DownUp(128, 64, 3, dropout=d)
            self.conv1d_at = ConvBN(64, 1, 1, batchnorm=False)
            cdu10_in = 128
        elif not self.no_dec3 and (variant == "piramid_res" or self.use_att):
            self.cdu7 = Conv2DownUp(128, 64, 3, dropout=d)
            self.conv1d_at_d = ConvBN(64, 1, 1, batchnorm=False)
            self.cdu8 = Conv2DownUp(32, 64, 3, dropout=d)
            self.cdu9 = Conv2DownUp(128, 64, 3, dropout=d)
            self.conv1d_at_s = ConvBN(64, 1, 1, batchnorm=False)
            cdu10_in = 64 if variant == "piramid_res" else 128
        elif not self.no_dec3:
            self.cdu8 = Conv2DownUp(32, 64, 3, dropout=d)
            cdu10_in = 192
        self.cdu10 = Conv2DownUp(cdu10_in, 64, 3, dropout=d)

        cdu11_ch = 64 if variant == "piramid_res" else 32
        if self.aspp_mod == 2:
            fskip_ch = c0
        else:
            fskip_ch = c_py0 if variant in ("piramid", "piramid_res") else 1
        self.conv1d_5 = ConvBN(64 + fskip_ch, 32, 1, batchnorm=False, relu=True)
        head_dropout = 0.0 if self.conv_deconv_out and self.aspp_mod != 2 else d
        self.cdu11 = Conv2DownUp(32, cdu11_ch, 3, last_layer=False, dropout=head_dropout)
        if self.conv_deconv_out and self.aspp_mod != 2:
            self.convOutput2 = conv2d(cdu11_ch, labels, 3)
            if self.conv_deconv_out == 2:
                self.convOutput = ConvOut(cdu11_ch, labels, 3)
        else:
            self.cdu11_out = ConvOut(cdu11_ch, labels, 3)
        if self.hanet and self.aspp_mod != 2:
            self.hanet_last = HANetConv(c0, labels, dropout_prob=0.1,
                                        is_encoding=cfg.hanet_is_encoding,
                                        pos_noise=cfg.hanet_pos_noise)
        if self.multaskloss:
            self.log_var_disp = nn.Parameter(torch.zeros(1))
            self.log_var_seg1 = nn.Parameter(torch.zeros(1))
            self.log_var_seg2 = nn.Parameter(torch.zeros(1))

    def gate_dropout(self, t: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout > 0:
            return F.dropout(t, self.dropout)
        return t

    def _multitask_terms(self, seg1, seg2, disp, disp_gt, seg_labels, seg2_var: bool):
        if disp_gt is None or seg_labels is None:
            return None
        return multitask_loss(self.log_var_disp, self.log_var_seg1,
                              self.log_var_seg2 if seg2_var else None, nhwc(disp), disp_gt,
                              nhwc(seg1), None if seg2 is None else nhwc(seg2), seg_labels)

    def _decoder_only(self, a4, full_hw, disp_gt, seg_labels):
        """multaskloss 2 (``sdnet.py:162-174``): both heads from a4 alone."""
        d = resize_bilinear(self.mt_disp_c2(self.mt_disp_c1(a4)), full_hw)
        s = resize_nearest(self.mt_seg_c2(self.mt_seg_c1(a4)), full_hw)
        out = {"seg1": nhwc(s), "disp1": nhwc(d), "seg2": nhwc(s), "disp2": nhwc(d)}
        mt = self._multitask_terms(s, None, d, disp_gt, seg_labels, seg2_var=False)
        if mt is not None:
            out["mt"] = mt
        return out

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor, pos=None,
                disp_gt=None, seg_labels=None) -> Dict[str, torch.Tensor]:
        image = nchw_channels_last(input_a)
        left, right = nchw_channels_last(input_a[..., :3]), nchw_channels_last(input_b[..., :3])
        full_hw = tuple(left.shape[-2:])

        # taps 0..4, then the enriched b2, b1, b0 (indices 5, 6, 7)
        a, b = both_views(self.features, left, right)
        a0, a1, a3, a4, a_py2, a_py1, a_py0 = (a[i] for i in (0, 1, 3, 4, 5, 6, 7))
        b3, b4, b_py2, b_py1 = (b[i] for i in (3, 4, 5, 6))
        if self.multaskloss == 2:
            return self._decoder_only(a4, full_hw, disp_gt, seg_labels)

        xleft_all = self.conv2d_ba(image)
        xleft0, xleft1, xleft2 = xleft_all[:, 0:1], xleft_all[:, 1:2], xleft_all[:, 2:3]
        if hasattr(self, "aspp_4"):
            a4, b4 = both_views(self.aspp_4, a4, b4)

        # head 1: coarse seg decoder on the concatenated deepest features
        x, x1, seg_branch = self.segNet(torch.cat([a4, b4], dim=1), full_hw, xleft0)

        # cost volume at 1/8 on the pyramid-enriched tap 2
        y = self.corrConv2d(cost_volume(a_py2, b_py2, self.patch, self.normalize))
        if self.variant == "piramid_res":
            # residual corr fusion (dsnet_t2.py:2340-2345)
            y = a_py2 + y
            y = y + resize_bilinear(self.cdu3(x1), y.shape[-2:])
        else:
            y1 = resize_bilinear(self.cdu3(a_py2 if self.no_dec1 else x1), y.shape[-2:])
            y = torch.cat([y1, y], dim=1)
        y = self.cdu4(y)

        # disparity head at full resolution
        y2 = upsample_nearest(y, 8)
        xl2 = resize_bilinear(xleft2, y2.shape[-2:])
        disp = self.conv1d_2(torch.cat([y2, xl2], dim=1))
        disp = self.dispoutConv(self.cdu5(disp))
        disp_out = resize_bilinear(disp, full_hw)

        # head 2: its features by aspp mode
        if self.aspp_mod == 1:
            s2 = self.aspp(a1)
        elif self.aspp_mod == 2:
            # one ASPP over both views' tap 3, then their 1-D correlation
            # (unnormalized, sdnet.py:266-270)
            s2_1, s2_2 = self.aspp(a3), self.aspp(b3)
            s2 = torch.cat([cost_volume(s2_1, s2_2, KERNEL_PATCH_1D, False), s2_1], dim=1)
        else:
            s2 = torch.cat([a_py1, b_py1], dim=1)
        s2 = self.cdu6(self.conv1d_4(s2))
        s2_hw = s2.shape[-2:]
        y3 = resize_nearest(y, s2_hw)
        # the modules run in the JAX model's call order (the dropout draws)
        if not self.no_dec3 and self.variant == "v2":
            # one self-gate (dsnet_t2.py:1861-1866)
            s2_d = self.cdu7(torch.cat([s2, y3], dim=1))
            x3 = resize_nearest(self.cdu8(x1), s2_hw)
            s2_s = self.cdu9(torch.cat([s2, x3], dim=1))
            s2_at = torch.sigmoid(self.conv1d_at(s2))
            s2 = torch.cat([s2_d * s2_at, s2_s * (1.0 - s2_at)], dim=1)
        elif not self.no_dec3 and self.variant == "piramid_res":
            # additive gate fusion (dsnet_t2.py:2375-2377)
            s2_d = self.cdu7(torch.cat([s2, y3], dim=1))
            at_d = torch.sigmoid(self.conv1d_at_d(s2_d))
            x3 = resize_nearest(self.cdu8(x1), s2_hw)
            s2_s = self.cdu9(torch.cat([s2, x3], dim=1))
            at_s = torch.sigmoid(self.conv1d_at_s(s2_s))
            s2 = s2 + (x3 * at_s + y3 * at_d)
        elif not self.no_dec3 and self.use_att:
            s2_d = self.cdu7(torch.cat([s2, y3], dim=1))
            at_d = self.gate_dropout(torch.sigmoid(self.conv1d_at_d(s2_d)))
            x3 = resize_nearest(self.cdu8(x1), s2_hw)
            s2_s = self.cdu9(torch.cat([s2, x3], dim=1))
            at_s = self.gate_dropout(torch.sigmoid(self.conv1d_at_s(s2_s)))
            s2 = torch.cat([s2_d * at_s, s2_s * at_d], dim=1)
        elif not self.no_dec3:
            x3 = resize_nearest(self.cdu8(x1), s2_hw)
            s2 = torch.cat([s2, x3, y3], dim=1)
        s2 = self.cdu10(s2)

        if self.aspp_mod == 2:
            # aspp 2's own head on the trunk's /2 tap (sdnet.py:344-366)
            s2 = torch.cat([resize_nearest(s2, a0.shape[-2:]), a0], dim=1)
            sb2 = self.cdu11_out(self.cdu11(self.conv1d_5(s2)))
            seg_branch2 = resize_nearest(sb2, full_hw)
        else:
            # piramid variants: the pyramid-enriched /2 map as the final skip
            fskip = a_py0 if self.variant in ("piramid", "piramid_res") else xleft1
            s2 = torch.cat([resize_nearest(s2, fskip.shape[-2:]), fskip], dim=1)
            sb2 = self.cdu11(self.conv1d_5(s2))
            if self.conv_deconv_out:
                seg_branch2 = self.convOutput2(sb2)
                if self.conv_deconv_out == 2:
                    seg_branch2 = self.convOutput(sb2) + seg_branch2
            else:
                seg_branch2 = self.cdu11_out(sb2)
            if self.variant in ("piramid", "piramid_res"):
                seg_branch2 = resize_nearest(seg_branch2, full_hw)
            if self.hanet:
                seg_branch2, _ = self.hanet_last(a0, seg_branch2, pos)

        out = {"seg1": nhwc(seg_branch), "disp1": nhwc(disp_out),
               "seg2": nhwc(seg_branch2), "disp2": nhwc(disp_out)}
        if self.multaskloss:
            mt = self._multitask_terms(seg_branch, seg_branch2, disp_out, disp_gt, seg_labels,
                                       seg2_var=True)
            if mt is not None:
                out["mt"] = mt
        return out


class MiniDSNet(nn.Module):
    """minidsnet (dsnet_t2.py:825-912), registered as ``sdnet_mini``: one seg
    and one disparity head, outputs duplicated (seg2 = seg1, disp2 = disp1),
    on the original piramidNet (``PiramidNetV1``), 1dcorr or 2dcorr (the
    latter normalized), with ``-edges`` as the flagship takes it. The trunk
    runs as ``both_views`` says (``sdnet.py:453-454``); the net has no
    dropout."""

    def __init__(self, cfg: ModelConfig, labels: int = 2):
        super().__init__()
        self.patch = corr_patch(cfg)
        self.normalize = cfg.corr_type != "1dcorr"
        self.features = PiramidNetV1()
        taps = self.features.out_channels
        # the JAX package's merge of the reference's image convs: channel 0
        # feeds the seg head, channel 1 the disparity head
        self.conv2d_ba = ConvBN(image_channels(cfg), 2, 5, dilation=2, relu=True)
        self.segNet = SegNetHead(2 * taps[4], labels)
        self.corrConv2d = ConvBN(self.patch[0] * self.patch[1], 128, 1, batchnorm=False,
                                 relu=True)
        self.cdu3 = Conv2DownUp(32, 128, 3)
        self.cdu4 = Conv2DownUp(256, 64, 3)
        self.conv1d_2 = ConvBN(64 + 1, 64, 1, batchnorm=False, relu=True)
        self.cdu5 = Conv2DownUp(64, 64, 5, last_layer=False)
        self.dispoutConv = ConvOut(64, 1, 5)

    def forward(self, input_a: torch.Tensor, input_b: torch.Tensor, **_) -> Dict[str, torch.Tensor]:
        image = nchw_channels_last(input_a)
        left, right = nchw_channels_last(input_a[..., :3]), nchw_channels_last(input_b[..., :3])
        full_hw = tuple(left.shape[-2:])
        a, b = both_views(self.features, left, right)
        a4, a_py2 = a[4], a[5]
        b4, b_py2 = b[4], b[5]

        xleft_all = self.conv2d_ba(image)
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


@MODELS.register("sdnet_mini_ext_v2")
def _make_ext_v2(cfg: ModelConfig, labels: int) -> MiniDSNetExt:
    return MiniDSNetExt(cfg, labels=labels, variant="v2")


@MODELS.register("sdnet_mini_ext_piramid")
def _make_ext_piramid(cfg: ModelConfig, labels: int) -> MiniDSNetExt:
    return MiniDSNetExt(cfg, labels=labels, variant="piramid")


@MODELS.register("sdnet_mini_ext_piramid_res")
def _make_ext_piramid_res(cfg: ModelConfig, labels: int) -> MiniDSNetExt:
    return MiniDSNetExt(cfg, labels=labels, variant="piramid_res")


@MODELS.register("sdnet_mini")
def _make_mini(cfg: ModelConfig, labels: int) -> MiniDSNet:
    return MiniDSNet(cfg, labels=labels)
