"""EncoderDecoderNet: a UNet-hypercolumn segmentor with SCSE / SE-IBN /
ObjectContext decoders, NHWC in and out, NCHW channels_last inside.

Counterpart of the JAX package's ``models/encdec.py`` (reference
models_deeplab/net.py:12-79, decoder.py:10-52, scse.py, ibn.py, oc.py,
encoder.py:8-37). The CLI does not reach it (it is not in ``VALID_NETS``, as
in the JAX package); it is built directly, ``EncoderDecoderNet(labels,
enc_type, dec_type, num_filters)``, and its weights come from
``init_parameters``, ``load_jax_variables`` or the reference importer
(``utils/torch_import.py:encdec_entries``).

Children are named after the flax modules and registered in the flax call
order. As in the JAX model:

* the ObjectContext attention is a plain product over (HW, HW) per sample:
  the logits in fp32 (the JAX einsum's ``preferred_element_type``; under
  the bf16 policy the bf16 keys are widened, so the products are exact and
  the sums fp32), a softmax scaled by ``key_channels ** -0.5``, the values
  weighted in fp32; the query is the key (oc.py:41) and the output conv
  ``W`` starts at zero;
* SE-IBN's instance-norm half is flax ``LayerNorm`` over H and W with a
  per-channel scale and bias, eps 1e-5, computed as flax computes it
  (``InstanceNorm``);
* ``pool5`` is a VALID 2x2 max (odd sizes floor), the stem's max pool pads
  with -inf, and every decoder ends in flax's SAME 4x4 stride-2 transposed
  conv with a bias (``blocks.SameConvTranspose2d``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .blocks import SameConvTranspose2d, batch_norm, conv2d
from .sdnet import nchw_channels_last, nhwc


class SELayer(nn.Module):
    """scse.py:5-20: squeeze, bias-free ``fc1`` (int(c / reduction)), ReLU,
    bias-free ``fc2``, sigmoid, excite."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(c, int(c / reduction), bias=False)
        self.fc2 = nn.Linear(int(c / reduction), c, bias=False)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean((2, 3))))))
        return x * y[:, :, None, None]


class SCSEBlock(nn.Module):
    """scse.py:23-43: concurrent channel (``fc1``/``fc2`` with biases) and
    spatial (bias-free 1x1 ``spatial``) excitation, summed."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(c, int(c // reduction))
        self.fc2 = nn.Linear(int(c // reduction), c)
        self.spatial = conv2d(c, 1, 1, init="lecun")

    def forward(self, x):
        chn = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean((2, 3))))))
        return x * chn[:, :, None, None] + x * torch.sigmoid(self.spatial(x))


class InstanceNorm(nn.InstanceNorm2d):
    """flax ``LayerNorm(reduction_axes=(1, 2), feature_axes=-1)``: each map
    normalised by its own mean and variance over H and W, both in fp32 at
    least, the
    variance as E[x^2] - E[x]^2 clipped at 0, then scaled and shifted per
    channel. torch's ``instance_norm`` takes the variance in two passes and
    refuses a 1x1 map, which the center decoder meets on a 64x64 input
    (flax gives the bias there)."""

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((2, 3), keepdim=True)
        var = ((xf * xf).mean((2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return ((xf - mean) * mul + self.bias[:, None, None]).to(x.dtype)


class SelfAttentionBlock2D(nn.Module):
    """oc.py:12-68: a non-local block whose query is its key (``f_key`` and
    ``key_bn``, then ReLU), values by ``f_value``, the context through the
    zero-initialised 1x1 ``W``; at ``scale`` > 1 over a VALID max pool of the
    input, the context resized back."""

    def __init__(self, cin: int, key_channels: int, value_channels: int,
                 out_channels: Optional[int] = None, scale: int = 1):
        super().__init__()
        self.key_channels, self.value_channels, self.scale = key_channels, value_channels, scale
        self.f_key = conv2d(cin, key_channels, 1, bias=True, init="lecun")
        self.key_bn = batch_norm(key_channels)
        self.f_value = conv2d(cin, value_channels, 1, bias=True, init="lecun")
        self.W = conv2d(value_channels, out_channels or cin, 1, bias=True, init="zeros")

    def forward(self, x):
        h, w = x.shape[-2:]
        xs = F.max_pool2d(x, self.scale, self.scale) if self.scale > 1 else x
        b, _, hs, ws = xs.shape
        wide = torch.promote_types(x.dtype, torch.float32)
        k = F.relu(self.key_bn(self.f_key(xs))).flatten(2).to(wide)    # (B, Ck, HW)
        v = self.f_value(xs).flatten(2).transpose(1, 2).to(wide)       # (B, HW, Cv)
        sim = torch.bmm(k.transpose(1, 2), k).mul_(self.key_channels ** -0.5)
        ctx = torch.bmm(torch.softmax(sim, dim=-1), v)                  # (B, HW, Cv)
        ctx = ctx.transpose(1, 2).reshape(b, self.value_channels, hs, ws).to(x.dtype)
        ctx = self.W(ctx.contiguous(memory_format=torch.channels_last))
        return resize_bilinear(ctx, (h, w)) if self.scale > 1 else ctx


class BaseOC(nn.Module):
    """oc.py:102-112: 3x3 ``conv`` + ``bn`` (ReLU), the attention ``attn``,
    1x1 ``proj`` + ``proj_bn`` (ReLU), dropout."""

    def __init__(self, cin: int, out_channels: int = 256, dropout: float = 0.05):
        super().__init__()
        self.conv = conv2d(cin, out_channels, 3, bias=True, init="lecun")
        self.bn = batch_norm(out_channels)
        self.attn = SelfAttentionBlock2D(out_channels, out_channels // 2, out_channels // 2,
                                         out_channels)
        self.proj = conv2d(out_channels, out_channels, 1, bias=True, init="lecun")
        self.proj_bn = batch_norm(out_channels)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        y = F.relu(self.bn(self.conv(x)))
        ctx = F.relu(self.proj_bn(self.proj(self.attn(y))))
        return self.drop(ctx)


def _up(cin: int, cout: int) -> SameConvTranspose2d:
    """flax ``ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME")``
    with its bias and flax's default lecun init."""
    return SameConvTranspose2d(cin, cout, 4, 2, bias=True, init="lecun")


class DecoderUnetSCSE(nn.Module):
    """decoder.py:10-22: the inputs concatenated, 3x3 ``conv`` + ``bn``
    (ReLU), ``scse``, ``up``."""

    def __init__(self, cin: int, middle: int, out: int):
        super().__init__()
        self.conv = conv2d(cin, middle, 3, bias=True, init="lecun")
        self.bn = batch_norm(middle)
        self.scse = SCSEBlock(middle)
        self.up = _up(middle, out)

    def forward(self, *args):
        x = torch.cat(args, dim=1) if len(args) > 1 else args[0]
        return self.up(self.scse(F.relu(self.bn(self.conv(x)))))


class DecoderUnetSEIBN(nn.Module):
    """decoder.py:25-35 with ibn.py: ``se``, then the IBN-a decoder block:
    1x1 ``reduce`` to q = cin // 4, ``inorm`` on the first q // 2 channels
    and ``bnorm`` on the rest (each ReLU), ``up`` q -> q with ``up_bn``
    (ReLU), 1x1 ``proj`` with ``proj_bn`` (ReLU). ``middle`` is unused, as in
    the reference."""

    def __init__(self, cin: int, middle: int, out: int):
        super().__init__()
        q = cin // 4
        self.half = q // 2
        self.se = SELayer(cin)
        self.reduce = conv2d(cin, q, 1, bias=True, init="lecun")
        self.inorm = InstanceNorm(self.half, eps=1e-5, affine=True)
        self.bnorm = batch_norm(q - self.half)
        self.up = _up(q, q)
        self.up_bn = batch_norm(q)
        self.proj = conv2d(q, out, 1, bias=True, init="lecun")
        self.proj_bn = batch_norm(out)

    def forward(self, *args):
        x = torch.cat(args, dim=1) if len(args) > 1 else args[0]
        y = self.reduce(self.se(x))
        a = F.relu(self.inorm(y[:, :self.half]))
        b = F.relu(self.bnorm(y[:, self.half:]))
        y = torch.cat([a, b], dim=1).contiguous(memory_format=torch.channels_last)
        y = F.relu(self.up_bn(self.up(y)))
        return F.relu(self.proj_bn(self.proj(y)))


class DecoderUnetOC(nn.Module):
    """decoder.py:38-52: 3x3 ``conv`` + ``bn`` (ReLU), ``oc`` (``BaseOC`` at
    ``middle`` channels, dropout 0.2), ``up``."""

    def __init__(self, cin: int, middle: int, out: int):
        super().__init__()
        self.conv = conv2d(cin, middle, 3, bias=True, init="lecun")
        self.bn = batch_norm(middle)
        self.oc = BaseOC(middle, middle, dropout=0.2)
        self.up = _up(middle, out)

    def forward(self, *args):
        x = torch.cat(args, dim=1) if len(args) > 1 else args[0]
        return self.up(self.oc(F.relu(self.bn(self.conv(x)))))


DECODERS = {"unet_scse": DecoderUnetSCSE, "unet_seibn": DecoderUnetSEIBN,
            "unet_oc": DecoderUnetOC}


class _ResBlock(nn.Module):
    """torchvision's Bottleneck: 1x1 ``c1``/``b1``, 3x3 ``c2``/``b2`` at the
    stride, 1x1 ``c3``/``b3`` to 4 x planes; the projected skip
    ``down``/``down_bn`` where ``down``."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, down: bool = False):
        super().__init__()
        self.c1 = conv2d(cin, planes, 1)
        self.b1 = batch_norm(planes)
        self.c2 = conv2d(planes, planes, 3, stride=stride, padding=1)
        self.b2 = batch_norm(planes)
        self.c3 = conv2d(planes, planes * 4, 1)
        self.b3 = batch_norm(planes * 4)
        if down:
            self.down = conv2d(cin, planes * 4, 1, stride=stride, padding=0)
            self.down_bn = batch_norm(planes * 4)
        self.has_down = down

    def forward(self, x):
        y = F.relu(self.b1(self.c1(x)))
        y = F.relu(self.b2(self.c2(y)))
        y = self.b3(self.c3(y))
        res = self.down_bn(self.down(x)) if self.has_down else x
        return F.relu(y + res)


class _BasicResBlock(nn.Module):
    """torchvision's BasicBlock (resnet18/34): 3x3 ``c1``/``b1`` at the
    stride, 3x3 ``c2``/``b2``; the projected skip where ``down``, identity
    otherwise (layer 1)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, down: bool = False):
        super().__init__()
        self.c1 = conv2d(cin, planes, 3, stride=stride, padding=1)
        self.b1 = batch_norm(planes)
        self.c2 = conv2d(planes, planes, 3)
        self.b2 = batch_norm(planes)
        if down:
            self.down = conv2d(cin, planes, 1, stride=stride, padding=0)
            self.down_bn = batch_norm(planes)
        self.has_down = down

    def forward(self, x):
        y = F.relu(self.b1(self.c1(x)))
        y = self.b2(self.c2(y))
        res = self.down_bn(self.down(x)) if self.has_down else x
        return F.relu(y + res)


# enc_type -> (stage block counts, bottleneck?): the torchvision resnets the
# reference's create_encoder reaches (encoder.py:17-36)
RESNET_LAYERS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}


class EncoderDecoderNet(nn.Module):
    """models_deeplab/net.py:12-79: a ResNet 5-stage encoder (``stem`` 7x7/2
    + ``stem_bn`` + max pool: e1 at /4; ``l{1..4}_b{i}``: e2..e5 at /4../32),
    ``pool5`` at /64, the decoders ``center``, ``dec5``..``dec1`` (each 2x
    up; dec1 takes e1 resized 2x), the hypercolumn of d1 and d2..d5 resized
    to the input, 1x1 ``logits1`` + ``logits_bn`` (ReLU) + 1x1 ``logits2``.
    Takes the left image (NHWC; ``right`` is ignored) and returns
    ``{"seg1": logits, "disp1": None, "seg2": None, "disp2": None}``."""

    def __init__(self, labels: int = 19, enc_type: str = "resnet50", dec_type: str = "unet_scse",
                 num_filters: int = 16):
        super().__init__()
        if enc_type not in RESNET_LAYERS:
            raise ValueError(f"unknown enc_type {enc_type!r}: one of {sorted(RESNET_LAYERS)}")
        if dec_type not in DECODERS:
            raise ValueError(f"unknown dec_type {dec_type!r}: one of {sorted(DECODERS)}")
        self.enc_type, self.dec_type, self.labels = enc_type, dec_type, labels
        layers, bottleneck = RESNET_LAYERS[enc_type]
        block = _ResBlock if bottleneck else _BasicResBlock
        self.stem = conv2d(3, 64, 7, stride=2, padding=3)
        self.stem_bn = batch_norm(64)
        self.stages = []
        cin, channels = 64, []
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            names = []
            for bi in range(n):
                stride = 2 if (bi == 0 and li > 0) else 1
                down = bi == 0 and (bottleneck or li > 0)
                name = f"l{li + 1}_b{bi}"
                self.add_module(name, block(cin, planes, stride, down))
                names.append(name)
                cin = planes * block.expansion
            self.stages.append(names)
            channels.append(cin)
        c2, c3, c4, c5 = channels
        nf, dec = num_filters, DECODERS[dec_type]
        self.center = dec(c5, nf * 64, nf * 32)
        self.dec5 = dec(nf * 32 + c5, nf * 64, nf * 16)
        self.dec4 = dec(nf * 16 + c4, nf * 32, nf * 8)
        self.dec3 = dec(nf * 8 + c3, nf * 16, nf * 4)
        self.dec2 = dec(nf * 4 + c2, nf * 8, nf * 2)
        self.dec1 = dec(nf * 2 + 64, nf * 4, nf)
        self.logits1 = conv2d(nf * 31, 64, 1, bias=True, init="lecun")
        self.logits_bn = batch_norm(64)
        self.logits2 = conv2d(64, labels, 1, bias=True, init="lecun")

    def forward(self, x, right=None, **_) -> Dict[str, Optional[torch.Tensor]]:
        x = nchw_channels_last(x)
        hw = tuple(x.shape[-2:])
        e1 = F.max_pool2d(F.relu(self.stem_bn(self.stem(x))), 3, 2, padding=1)  # pads with -inf
        e, feats = e1, []
        for names in self.stages:
            for name in names:
                e = getattr(self, name)(e)
            feats.append(e)
        e2, e3, e4, e5 = feats
        c = self.center(F.max_pool2d(e5, 2, 2))
        d5 = self.dec5(c, e5)
        d4 = self.dec4(d5, e4)
        d3 = self.dec3(d4, e3)
        d2 = self.dec2(d3, e2)
        e1_up = resize_bilinear(e1, (e1.shape[2] * 2, e1.shape[3] * 2))
        d1 = self.dec1(d2, e1_up)
        d = torch.cat([d1] + [resize_bilinear(t, hw) for t in (d2, d3, d4, d5)], dim=1)
        y = F.relu(self.logits_bn(self.logits1(d)))
        return {"seg1": nhwc(self.logits2(y)), "disp1": None, "seg2": None, "disp2": None}
