"""DeepLabV3+, mono (``deeplab``) and stereo (``deeplab_mod``). Counterpart
of the JAX package's ``models/deeplab.py`` (reference models_deeplab/net.py
:82-135, models_deeplab_mod/net.py:82-169, xception.py, mobilenet.py,
spp.py, common.py), NHWC in and out, NCHW channels_last inside.

* ``Xception65`` at output stride 8 or 16; the stereo net's variant also
  returns the separable-conv taps of middle-flow blocks 8 and 14;
  ``MobileNetV2Encoder`` (output stride 8, 320 channels). The encoders'
  BatchNorm eps is 1e-3 (the reference's ``update_bn_eps``), the rest of the
  net keeps 1e-5.
* ``ASPPDeeplab`` (separable-conv ASPP), ``MobileASPP`` and ``SPPDecoder``
  (with ``concat_prev``, the stereo net's chained decoders).
* ``SPPNetMono`` returns the seg logits at the decoder's resolution (seg1;
  the other heads are None: the step fakes them with the ground truth).
* ``SPPNetStereo`` correlates ``conv2`` of both views' block-8 taps with
  corr1d (256 channels at output stride 8 of the padded input: 65x121 at
  512x960) and chains three decoders (seg -> disp -> seg2).
* ``deeplab_preprocess`` scales the LEFT view to [-1, 1] (only the left: the
  JAX package's rule) and pads both views by one row and column;
  ``deeplab_postprocess`` resizes a head with align_corners=True to (h + 1,
  w + 1) and crops it to (h, w).

The dropout of the ASPPs is channel-wise (``Dropout2d``, 0.1) in train mode.
In train mode the stereo net's encoder runs once per view; in eval mode the
two views share one pass through block 8, and only the left view runs the
rest of the encoder (the right view's later blocks feed nothing).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.registry import MODELS
from ..ops.resize import resize_bilinear_align_corners
from .blocks import batch_norm, conv2d
from .sdnet import cost_volume, nchw_channels_last, nhwc

ENCODER_BN_EPS = 1e-3
KERNEL_PATCH_1D = (1, 17)


class SeparableConv(nn.Module):
    """SeparableConv2d (models_deeplab/common.py:25-52): a depthwise 3x3
    (padding = dilation) and a pointwise 1x1, each with its BatchNorm; ReLU
    first, or after each BatchNorm (``relu_first=False``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu_first: bool = True, bn_eps: float = 1e-5):
        super().__init__()
        self.relu_first = relu_first
        self.depthwise = conv2d(cin, cin, kernel, stride=stride, dilation=dilation,
                                padding=dilation, groups=cin)
        self.bn_depth = batch_norm(cin, bn_eps)
        self.pointwise = conv2d(cin, features, 1)
        self.bn_point = batch_norm(features, bn_eps)

    def forward(self, x):
        if self.relu_first:
            x = F.relu(x)
        x = self.bn_depth(self.depthwise(x))
        if not self.relu_first:
            x = F.relu(x)
        x = self.bn_point(self.pointwise(x))
        return x if self.relu_first else F.relu(x)


class XceptionBlock(nn.Module):
    """models_deeplab/xception.py:7-46: three separable convs (the last
    strided) and a 1x1 projected (``conv``), identity (``sum``) or no
    (``none``) skip. ``forward`` returns (out, the second separable conv's
    output): the low-level tap of block 2 and the stereo net's taps."""

    def __init__(self, channels: Tuple[int, int, int, int], stride: int = 1, dilation: int = 1,
                 skip: str = "conv", relu_first: bool = True, bn_eps: float = 1e-5):
        super().__init__()
        kw = dict(relu_first=relu_first, dilation=dilation, bn_eps=bn_eps)
        self.skip = skip
        self.sep1 = SeparableConv(channels[0], channels[1], **kw)
        self.sep2 = SeparableConv(channels[1], channels[2], **kw)
        self.sep3 = SeparableConv(channels[2], channels[3], stride=stride, **kw)
        if skip == "conv":
            self.skip_conv = conv2d(channels[0], channels[3], 1, stride=stride, padding=0)
            self.skip_bn = batch_norm(channels[3], bn_eps)

    def forward(self, x):
        sc2 = self.sep2(self.sep1(x))
        out = self.sep3(sc2)
        if self.skip == "conv":
            out = out + self.skip_bn(self.skip_conv(x))
        elif self.skip == "sum":
            out = out + x
        return out, sc2


class Xception65(nn.Module):
    """models_deeplab/xception.py:49-135: the stem, entry blocks 1-3, middle
    blocks 4-19, exit blocks 20-21 (2048 channels). ``head`` runs the stem
    through block 8 and returns (x, low, mid2); ``tail`` the rest, returning
    (x, high3): the taps of blocks 8 and 14 (``mid2``, ``high3``) are the
    stereo net's."""

    def __init__(self, output_stride: int = 8, bn_eps: float = ENCODER_BN_EPS, in_channels: int = 3):
        super().__init__()
        if output_stride == 16:
            entry3_stride, mid_dil, exit_dil = 2, 1, (1, 2)
        elif output_stride == 8:
            entry3_stride, mid_dil, exit_dil = 1, 2, (2, 4)
        else:
            raise NotImplementedError(f"output stride {output_stride}: 8 or 16")
        eps = bn_eps
        self.conv1 = conv2d(in_channels, 32, 3, stride=2, padding=1)
        self.bn1 = batch_norm(32, eps)
        self.conv2 = conv2d(32, 64, 3, padding=1)
        self.bn2 = batch_norm(64, eps)
        self.block1 = XceptionBlock((64, 128, 128, 128), stride=2, bn_eps=eps)
        self.block2 = XceptionBlock((128, 256, 256, 256), stride=2, bn_eps=eps)
        self.block3 = XceptionBlock((256, 728, 728, 728), stride=entry3_stride, bn_eps=eps)
        for i in range(4, 20):
            self.add_module(f"block{i}", XceptionBlock((728,) * 4, dilation=mid_dil, skip="sum",
                                                       bn_eps=eps))
        self.block20 = XceptionBlock((728, 728, 1024, 1024), dilation=exit_dil[0], bn_eps=eps)
        self.block21 = XceptionBlock((1024, 1536, 1536, 2048), dilation=exit_dil[1], skip="none",
                                     relu_first=False, bn_eps=eps)

    def head(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x, _ = self.block1(x)
        x, low = self.block2(x)
        x, _ = self.block3(x)
        for i in range(4, 9):
            x, mid2 = getattr(self, f"block{i}")(x)
        return x, low, mid2

    def tail(self, x):
        for i in range(9, 22):
            x, tap = getattr(self, f"block{i}")(x)
            if i == 14:
                high3 = tap
        return x, high3

    def forward(self, x):
        """(x, low, mid2, high3)."""
        x, low, mid2 = self.head(x)
        x, high3 = self.tail(x)
        return x, low, mid2, high3


def _relu6(x):
    return torch.clamp(F.relu(x), max=6.0)


# (cin, cout, stride, dilation, ratio, skip) -- mobilenet.py:61-77
MOBILENETV2_CFG = (
    (32, 16, 1, 1, 1, False), (16, 24, 2, 1, 6, False), (24, 24, 1, 1, 6, True),
    (24, 32, 2, 1, 6, False), (32, 32, 1, 1, 6, True), (32, 32, 1, 1, 6, True),
    (32, 64, 1, 1, 6, False), (64, 64, 1, 2, 6, True), (64, 64, 1, 2, 6, True),
    (64, 64, 1, 2, 6, True), (64, 96, 1, 2, 6, False), (96, 96, 1, 2, 6, True),
    (96, 96, 1, 2, 6, True), (96, 160, 1, 2, 6, False), (160, 160, 1, 4, 6, True),
    (160, 160, 1, 4, 6, True), (160, 320, 1, 4, 6, False),
)


class MobileNetV2Encoder(nn.Module):
    """models_deeplab/mobilenet.py:53-103 (output stride 8, 320 channels
    out): a stride-2 stem and 17 expanded convs, block i as the layers
    ``block{i}_expand``/``_ebn`` (a 1x1 expansion, unless the ratio is 1),
    ``block{i}_dw``/``_dbn`` (a dilated depthwise 3x3) and
    ``block{i}_proj``/``_pbn`` (a 1x1 projection), ReLU6 after the first two
    BatchNorms and a residual add where the block has one (the JAX module's
    flat names)."""

    def __init__(self, bn_eps: float = ENCODER_BN_EPS, in_channels: int = 3):
        super().__init__()
        self.stem = conv2d(in_channels, 32, 3, stride=2, padding=1)
        self.stem_bn = batch_norm(32, bn_eps)
        for i, (ci, co, s, d, r, _) in enumerate(MOBILENETV2_CFG):
            mid = ci * r
            if r != 1:
                self.add_module(f"block{i}_expand", conv2d(ci, mid, 1))
                self.add_module(f"block{i}_ebn", batch_norm(mid, bn_eps))
            self.add_module(f"block{i}_dw", conv2d(mid, mid, 3, stride=s, dilation=d, padding=d,
                                                   groups=mid))
            self.add_module(f"block{i}_dbn", batch_norm(mid, bn_eps))
            self.add_module(f"block{i}_proj", conv2d(mid, co, 1))
            self.add_module(f"block{i}_pbn", batch_norm(co, bn_eps))

    def forward(self, x):
        x = _relu6(self.stem_bn(self.stem(x)))
        for i, (*_, ratio, skip) in enumerate(MOBILENETV2_CFG):
            layer = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            y = _relu6(layer("ebn")(layer("expand")(x))) if ratio != 1 else x
            y = _relu6(layer("dbn")(layer("dw")(y)))
            y = layer("pbn")(layer("proj")(y))
            x = x + y if skip else y
        return x


def _conv_bn_relu(x, conv, bn):
    return F.relu(bn(conv(x)))


class ASPPDeeplab(nn.Module):
    """models_deeplab/spp.py:34-77: a pooled branch (resized back with
    align_corners), a 1x1 branch and three separable atrous branches
    (dilations 12/24/36 at output stride 8, 6/12/18 at 16), projected to
    ``features`` channels, then channel-wise dropout 0.1 in train mode."""

    def __init__(self, cin: int, features: int = 256, output_stride: int = 8):
        super().__init__()
        self.gap_conv = conv2d(cin, features, 1)
        self.gap_bn = batch_norm(features)
        self.aspp0_conv = conv2d(cin, features, 1)
        self.aspp0_bn = batch_norm(features)
        for i, d in enumerate((12, 24, 36) if output_stride == 8 else (6, 12, 18), start=1):
            self.add_module(f"aspp{i}", SeparableConv(cin, features, dilation=d, relu_first=False))
        self.proj = conv2d(5 * features, features, 1)
        self.proj_bn = batch_norm(features)
        self.out_channels = features

    def forward(self, x):
        pool = _conv_bn_relu(x.mean(dim=(2, 3), keepdim=True), self.gap_conv, self.gap_bn)
        outs = [resize_bilinear_align_corners(pool, x.shape[-2:]),
                _conv_bn_relu(x, self.aspp0_conv, self.aspp0_bn)]
        outs += [getattr(self, f"aspp{i}")(x) for i in (1, 2, 3)]
        y = _conv_bn_relu(torch.cat(outs, dim=1), self.proj, self.proj_bn)
        return F.dropout2d(y, 0.1, training=self.training)


class MobileASPP(nn.Module):
    """models_deeplab/spp.py:80-108: the pooled and the 1x1 branch only."""

    def __init__(self, cin: int):
        super().__init__()
        self.gap_conv = conv2d(cin, 256, 1)
        self.gap_bn = batch_norm(256)
        self.aspp0_conv = conv2d(cin, 256, 1)
        self.aspp0_bn = batch_norm(256)
        self.proj = conv2d(512, 256, 1)
        self.proj_bn = batch_norm(256)
        self.out_channels = 256

    def forward(self, x):
        pool = _conv_bn_relu(x.mean(dim=(2, 3), keepdim=True), self.gap_conv, self.gap_bn)
        y = torch.cat([resize_bilinear_align_corners(pool, x.shape[-2:]),
                       _conv_bn_relu(x, self.aspp0_conv, self.aspp0_bn)], dim=1)
        return F.dropout2d(_conv_bn_relu(y, self.proj, self.proj_bn), 0.1, training=self.training)


class SPPDecoder(nn.Module):
    """models_deeplab_mod/spp.py:131-157: x resized (align_corners) to the
    low-level map, concatenated with its 48-channel 1x1 projection (and,
    with ``concat_prev``, a 64-channel 1x1 projection of the previous
    decoder's concat), then two separable convs to 256 channels. Returns
    (the output, the concat)."""

    def __init__(self, cin: int, low_channels: int, concat_prev: int = 0, reduced: int = 48):
        super().__init__()
        self.low_conv = conv2d(low_channels, reduced, 1)
        self.low_bn = batch_norm(reduced)
        middle = cin + reduced
        if concat_prev:
            self.int_conv = conv2d(concat_prev, 64, 1)
            middle += 64
        self.concat_prev = concat_prev
        self.sep1 = SeparableConv(middle, 256, relu_first=False)
        self.sep2 = SeparableConv(256, 256, relu_first=False)
        self.middle_channels = middle

    def forward(self, x, low_level_feat, other_feat: Optional[torch.Tensor] = None):
        x = resize_bilinear_align_corners(x, low_level_feat.shape[-2:])
        parts = [x, _conv_bn_relu(low_level_feat, self.low_conv, self.low_bn)]
        if self.concat_prev:
            parts.append(self.int_conv(other_feat))
        middle = torch.cat(parts, dim=1)
        return self.sep2(self.sep1(middle)), middle


def _logits(cin: int, cout: int) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (1, 1))``: biased, lecun normal."""
    return conv2d(cin, cout, 1, bias=True, init="lecun")


class SPPNetMono(nn.Module):
    """models_deeplab/net.py SPPNet, ``deeplab``: Xception-65 + ASPP +
    decoder, or (``enc_type="mobilenetv2"``) MobileNetV2 + the full ASPP
    (``dec_type="aspp"``, the reference's ``create_mspp`` default) or
    ``MobileASPP`` (``"maspp"``) with no decoder."""

    def __init__(self, labels: int = 19, enc_type: str = "xception65", dec_type: str = "aspp",
                 output_stride: int = 8, encoder_bn_eps: float = ENCODER_BN_EPS):
        super().__init__()
        self.enc_type = enc_type
        if enc_type == "mobilenetv2":
            self.encoder = MobileNetV2Encoder(encoder_bn_eps)
            self.spp = MobileASPP(320) if dec_type == "maspp" else ASPPDeeplab(320, 256, output_stride)
        else:
            self.encoder = Xception65(output_stride, encoder_bn_eps)
            self.spp = ASPPDeeplab(2048, 256, output_stride)
            self.decoder = SPPDecoder(256, 256)
        self.logits = _logits(256, labels)

    def forward(self, left: torch.Tensor, right: Optional[torch.Tensor] = None,
                **_) -> Dict[str, Optional[torch.Tensor]]:
        x = nchw_channels_last(left)
        if self.enc_type == "mobilenetv2":
            x = self.spp(self.encoder(x))
        else:
            x, low = self.encoder.head(x)[:2]
            x = self.spp(self.encoder.tail(x)[0])
            x, _ = self.decoder(x, low)
        return {"seg1": nhwc(self.logits(x)), "disp1": None, "seg2": None, "disp2": None}


class SPPNetStereo(nn.Module):
    """models_deeplab_mod/net.py SPPNet, ``deeplab_mod``: the Xception-65
    encoder over both views, corr1d between ``conv2`` of the views' block-8
    taps, and three chained decoders (seg -> disp -> seg2)."""

    def __init__(self, labels: int = 19, output_stride: int = 8,
                 encoder_bn_eps: float = ENCODER_BN_EPS):
        super().__init__()
        self.encoder = Xception65(output_stride, encoder_bn_eps)
        self.spp = ASPPDeeplab(2048, 256, output_stride)
        self.decoder = SPPDecoder(256, 256)
        self.conv2 = conv2d(728, 256, 1)
        self.corrConv = conv2d(KERNEL_PATCH_1D[1], 44, 1)
        self.conv3 = conv2d(728, 256, 1)
        self.decoder2 = SPPDecoder(256 + 44, 256, concat_prev=self.decoder.middle_channels)
        self.decoder3 = SPPDecoder(256, 256, concat_prev=self.decoder2.middle_channels)
        self.logits = _logits(256, labels)
        self.logits_disp = _logits(256, 1)
        self.logits_seg = _logits(256, labels)

    def forward(self, left: torch.Tensor, right: torch.Tensor, **_) -> Dict[str, torch.Tensor]:
        left, right = nchw_channels_last(left), nchw_channels_last(right)
        enc = self.encoder
        if self.training:  # once per view, as the JAX model runs it
            x, low, mid2, high3 = enc(left)
            mid2_b = enc(right)[2]
            m_a, m_b = self.conv2(mid2), self.conv2(mid2_b)
        else:  # both views through block 8 in one pass; the left view on
            n = left.shape[0]
            x, low, mid = enc.head(torch.cat([left, right], dim=0))
            x, high3 = enc.tail(x[:n])
            low, m = low[:n], self.conv2(mid)
            m_a, m_b = m[:n], m[n:]
        x, int_seg = self.decoder(self.spp(x), low)
        corr = F.relu(self.corrConv(cost_volume(m_a, m_b, KERNEL_PATCH_1D, False)))
        disp_x, int_disp = self.decoder2(torch.cat([m_a, corr], dim=1), low, int_seg)
        seg2_x, _ = self.decoder3(self.conv3(high3), low, int_disp)
        disp = nhwc(self.logits_disp(disp_x))
        return {"seg1": nhwc(self.logits(x)), "disp1": disp, "seg2": nhwc(self.logits_seg(seg2_x)),
                "disp2": disp}


def deeplab_preprocess(left: torch.Tensor, right: Optional[torch.Tensor] = None):
    """netForward's deeplab input path (torch_implementation.py:123-131):
    the left view scaled to [-1, 1], both views padded by one row and
    column at the bottom and right. NHWC; returns (left, right, (h, w))."""
    h, w = left.shape[1:3]
    left = F.pad(left * 2.0 - 1.0, (0, 0, 0, 1, 0, 1))
    if right is not None:
        right = F.pad(right, (0, 0, 0, 1, 0, 1))
    return left, right, (h, w)


def deeplab_postprocess(logits: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """A head (NHWC) resized with align_corners=True to (h + 1, w + 1) and
    cropped to (h, w) (torch_implementation.py:160-166)."""
    h, w = hw
    out = resize_bilinear_align_corners(logits.permute(0, 3, 1, 2), (h + 1, w + 1))
    return nhwc(out[..., :h, :w])


@MODELS.register("deeplab")
def _make_deeplab(cfg: ModelConfig, labels: int) -> SPPNetMono:
    # the reference class takes enc_type mobilenetv2 (net.py:89); its CLI
    # always builds the xception65 default, as the JAX package's factory does
    enc = "mobilenetv2" if cfg.backbone == "mobilenetv2" else "xception65"
    return SPPNetMono(labels=labels, enc_type=enc)


@MODELS.register("deeplab_mod")
def _make_deeplab_mod(cfg: ModelConfig, labels: int) -> SPPNetStereo:
    return SPPNetStereo(labels=labels)
