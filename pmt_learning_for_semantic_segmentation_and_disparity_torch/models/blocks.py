"""Shared building blocks of the SDNet family (NCHW ``nn.Module``s).

Counterparts of the JAX package's ``models/blocks.py``. Child and parameter
names follow the flax modules (``conv``/``deconv``/``bn``, ``c1``..``d5``) so
``models/jax_weights.py`` can carry a flax variable tree across by path.

* the heads' convolutions are bias-free, stride 1 with an odd kernel, so
  TF-'SAME' padding is the symmetric ``dilation * (k - 1) // 2``; the trunks
  add biased, grouped (depthwise) and explicitly padded convolutions
  (``conv2d``) and flax's ``padding="SAME"`` at stride 2, which pads
  asymmetrically (``SameConv2d``);
* BatchNorm has eps 1e-5 and torch's momentum 0.1 (flax momentum 0.9) by
  default, EfficientNet's eps 1e-3 and flax momentum 0.99 (``batch_norm``);
  in train mode it moves its running variance toward the biased batch
  variance, as flax does (``BatchNorm2d``);
* the stride-1 ``DeconvBN`` is a SAME convolution, as in the JAX package
  (a stride-1 'same' transposed conv is a conv with a flipped kernel, and the
  JAX package stores the kernel already in conv form);
* the stride-2 ``DeconvBN`` (``deconv_ba1``/``deconv_ba2`` of the legacy
  nets) is flax's ``nn.ConvTranspose(padding="SAME")``, see
  ``SameConvTranspose2d``;
* PSMNet's 3-D layers: ``conv3d`` (a 3x3x3 conv padded by one) and
  ``SameConvTranspose3d`` (flax's ``nn.ConvTranspose`` with explicit (1, 2)
  padding, 2x each dimension); ``batch_norm`` normalises (N, C, ...) maps
  of any rank.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# Weight initialisers of the JAX package, by name:
#   he_fan_out -- variance_scaling(2, fan_out, normal): ConvBN / DeconvBN
#   kaiming    -- variance_scaling(2, fan_in, truncated_normal): DenseNet convs
#   lecun      -- variance_scaling(1, fan_in, truncated_normal): ConvOut
_INIT_RULES = {
    "he_fan_out": (2.0, "fan_out", False),
    "kaiming": (2.0, "fan_in", True),
    "lecun": (1.0, "fan_in", True),
}
# std of a standard normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def conv2d(cin: int, cout: int, kernel: int, *, stride: int = 1, dilation: int = 1,
           padding: Optional[int] = None, groups: int = 1, bias: bool = False,
           init: str = "he_fan_out") -> nn.Conv2d:
    """Conv, bias-free unless ``bias``; SAME padding for a stride-1 odd
    kernel unless ``padding`` (symmetric) is given; ``groups`` = ``cin`` is a
    depthwise conv. ``init`` names the JAX initialiser that
    ``init_parameters`` uses (a bias starts at 0)."""
    if padding is None:
        if kernel % 2 == 0 or stride != 1:
            raise ValueError("SAME padding is implemented for stride-1 odd kernels only "
                             "(SameConv2d pads flax's SAME at any stride)")
        padding = dilation * (kernel - 1) // 2
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation,
                     groups=groups, bias=bias)
    conv.init_rule = init
    return conv


def same_padding(n: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """flax's (lax's) ``padding="SAME"`` along one axis of size ``n``: the
    output has ceil(n / stride) samples, and the total padding is split with
    the smaller half first."""
    total = max((-(-n // stride) - 1) * stride + (kernel - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """flax ``nn.Conv(padding="SAME")`` at any stride (EfficientNet's stem and
    depthwise convs; efficientnet_pytorch's static-same padding). At stride 2
    on an even input the padding is asymmetric, (0, 1) for a 3x3 kernel and
    (1, 2) for a 5x5: torch's symmetric ``padding=`` would shift the map by a
    pixel. The input is padded here, then convolved unpadded."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
                 bias: bool = False, init: str = "he_fan_out"):
        super().__init__(cin, cout, kernel, stride=stride, groups=groups, bias=bias)
        self.init_rule = init

    def forward(self, x):
        (k, _), (s, _), (d, _) = self.kernel_size, self.stride, self.dilation
        top, bottom = same_padding(x.shape[-2], k, s, d)
        left, right = same_padding(x.shape[-1], k, s, d)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left), self.dilation,
                            self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


class SameConvTranspose2d(nn.Conv2d):
    """flax ``nn.ConvTranspose(features, (k, k), strides=s, padding="SAME",
    use_bias=False)``: output = s x input, bias-free.

    The weight is kept in the conv layout (O, I, kh, kw), which is what
    ``load_jax_variables`` makes of flax's (kh, kw, I, O) kernel and what
    ``init_parameters`` reads its fan-out (kh*kw*O) from, as flax does. flax
    dilates the input by s and correlates it with the kernel unflipped, with
    lax's SAME transpose padding (pad_a before); torch's ``conv_transpose2d``
    scatters with the kernel flipped. So this runs ``conv_transpose2d`` with
    the weight as (I, O, kh, kw), flipped in space, and keeps s*H x s*W of
    its output from row and column k - 1 - pad_a on, copied back to
    channels_last (the crop is a strided view, which the layers after it
    would otherwise run in NCHW)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        if kernel % 2 == 0 or kernel < stride:
            raise ValueError("SameConvTranspose2d takes an odd kernel no smaller than the stride")
        super().__init__(cin, cout, kernel, bias=False)
        self.init_rule = "he_fan_out"
        self.up = stride
        pad_a = kernel - 1 if stride > kernel - 1 else math.ceil((kernel + stride - 2) / 2)
        self.offset = kernel - 1 - pad_a

    def forward(self, x):
        h, w = x.shape[-2:]
        s, o = self.up, self.offset
        y = F.conv_transpose2d(x, self.weight.transpose(0, 1).flip(-2, -1), stride=s)
        return y[..., o:o + s * h, o:o + s * w].contiguous(memory_format=torch.channels_last)


def conv3d(cin: int, cout: int, stride: int = 1) -> nn.Conv3d:
    """flax ``nn.Conv(cout, (3, 3, 3), strides=stride, padding=[(1, 1)] * 3,
    use_bias=False)`` with the he fan-out init (PSMNet's ``_ConvBN3d`` and
    its ``classif*b`` heads): flax's (kd, kh, kw, I, O) kernel is the port's
    (O, I, kd, kh, kw) weight."""
    conv = nn.Conv3d(cin, cout, 3, stride=stride, padding=1, bias=False)
    conv.init_rule = "he_fan_out"
    return conv


class SameConvTranspose3d(nn.Conv3d):
    """flax ``nn.ConvTranspose(features, (3, 3, 3), strides=2, padding=((1,
    2),) * 3, use_bias=False)`` (PSMNet's ``_Deconv3dBN``): 2x each
    dimension, bias-free.

    As in ``SameConvTranspose2d`` the weight keeps the conv layout (O, I, kd,
    kh, kw) that ``load_jax_variables`` makes of flax's (kd, kh, kw, I, O)
    kernel and that ``init_parameters`` reads its fan-out from. flax dilates
    the input by 2, pads it by (lo, hi) = (1, 2) and correlates it with the
    kernel unflipped; ``conv_transpose3d`` scatters with the kernel flipped.
    So the weight runs as (I, O, kd, kh, kw), flipped in space, with
    padding k - 1 - lo = 1 and output padding hi - lo = 1: out = 2 x in."""

    KERNEL, STRIDE, PAD = 3, 2, (1, 2)

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, self.KERNEL, bias=False)
        self.init_rule = "he_fan_out"

    def forward(self, x):
        lo, hi = self.PAD
        return F.conv_transpose3d(x, self.weight.transpose(0, 1).flip(-3, -2, -1),
                                  stride=self.STRIDE, padding=self.KERNEL - 1 - lo,
                                  output_padding=hi - lo)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running update is flax's (flax
    momentum m, 0.9 unless ``batch_norm`` is told otherwise):

        mean <- m * mean + (1 - m) * batch mean
        var  <- m * var  + (1 - m) * biased batch variance

    where torch's own update takes the unbiased variance, n/(n-1) times
    larger for n pixels per channel (8/7 at the deepest taps of a 1x64x128
    input). Train mode normalises by the batch statistics; eval mode by the
    running ones. The running buffers are updated in place in their own
    dtype, whatever the input's (fp32 under the bf16 policy). It takes maps
    of any rank (N, C, ...): PSMNet's 3-D BatchNorms are these too."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        # no running buffers in the op: autograd saves its inputs, and the
        # buffers change in place below and in the next call of this layer
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(invstd.pow(-2) - self.eps, alpha=m)
        return y


def batch_norm(c: int, eps: float = 1e-5, momentum: float = 0.9) -> BatchNorm2d:
    """flax ``nn.BatchNorm(epsilon=eps, momentum=momentum)``: flax's momentum
    is the running statistics' share kept a step, torch's the batch's, so
    torch's is ``1 - momentum`` (EfficientNet: eps 1e-3, flax 0.99, a step
    moves the running statistics by 0.01)."""
    return BatchNorm2d(c, eps=eps, momentum=1.0 - momentum)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``model`` from ``generator`` with
    the JAX package's initialisers (convolutions, 1-D to 3-D, by their
    ``init_rule``, or
    flax ``nn.Conv``'s default lecun normal where they have none, their
    biases 0; a grouped convolution's fan-in is that of one group, as flax's
    (k, k, C/groups, O) kernel gives it; ``nn.Linear``: flax ``nn.Dense``'s
    lecun normal, bias 0; BatchNorm: scale 1, bias 0, running mean 0,
    running var 1; an embedding: normal with std 1/sqrt(features), flax's
    ``nn.Embed``; any other parameter, e.g. a log-variance of the multitask
    loss: 0)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            rule = "lecun" if isinstance(m, nn.Linear) else getattr(m, "init_rule", "lecun")
            scale, mode, truncated = _INIT_RULES[rule]
            if isinstance(m, nn.Linear):
                receptive, fan_in, fan_out = 1, m.in_features, m.out_features
            else:
                receptive = m.weight[0, 0].numel()
                fan_in, fan_out = m.in_channels // m.groups, m.out_channels
            fan = receptive * (fan_in if mode == "fan_in" else fan_out)
            std = math.sqrt(scale / fan)
            if truncated:
                std /= _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            else:
                m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=generator)
        else:
            for p in m.parameters(recurse=False):
                p.zero_()
    return model


class ConvBN(nn.Module):
    """conv('SAME') [+BN] [+ReLU] [+dropout] (dsnet_t2.py:16-46)."""

    conv_name = "conv"

    def __init__(self, cin: int, features: int, kernel: int = 3, dilation: int = 1,
                 batchnorm: bool = True, relu: bool = False, dropout: float = 0.0):
        super().__init__()
        self.add_module(self.conv_name, conv2d(cin, features, kernel, dilation=dilation))
        self.bn = batch_norm(features) if batchnorm else None
        self.relu = relu
        self.drop = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x):
        x = getattr(self, self.conv_name)(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.relu:
            x = F.relu(x)
        if self.drop is not None:
            x = self.drop(x)
        return x


class DeconvBN(ConvBN):
    """deconvbn (dsnet_t2.py:48-77), its conv named ``deconv``: at stride 1 a
    SAME conv, at a larger stride the SAME transposed conv."""

    conv_name = "deconv"

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1, **kw):
        super().__init__(cin, features, kernel, **kw)
        if stride != 1:
            self.deconv = SameConvTranspose2d(cin, features, kernel, stride)


class ConvOut(nn.Module):
    """Bare bias-free SAME output conv (the reference's
    ConvTranspose2dSame(init_he=False) heads)."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.conv = conv2d(cin, features, kernel, init="lecun")

    def forward(self, x):
        return self.conv(x)


class Conv2DownUp(nn.Module):
    """3x conv(+bn+relu) then 3x deconv(+bn+relu) with residual adds after
    d3 and d4 (dsnet_t2.py:80-117). ``last_layer=False`` drops d5."""

    def __init__(self, cin: int, features: int, kernel: int = 3, last_layer: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        kw = dict(kernel=kernel, relu=True, dropout=dropout)
        self.c1 = ConvBN(cin, features, **kw)
        self.c2 = ConvBN(features, features, **kw)
        self.c3 = ConvBN(features, features, **kw)
        self.d3 = DeconvBN(features, features, **kw)
        self.d4 = DeconvBN(features, features, **kw)
        self.d5 = DeconvBN(features, features, **kw) if last_layer else None

    def forward(self, x):
        x1 = self.c1(x)
        x2 = self.c2(x1)
        y = self.d3(self.c3(x2))
        y = self.d4(x2 + y)
        y = x1 + y
        return y if self.d5 is None else self.d5(y)
