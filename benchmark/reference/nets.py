"""The two nets of the benchmark's configurations in plain PyTorch, NCHW:

* ``Flagship``: ``minidsnetExt`` (dsnet_t2.py:941-1299) on DenseNet-121 with
  the pyramid of ``PiramidNet2``, the 1-D (1, 17) correlation at 1/8, aspp 0
  and the cross-task attention gates (``-use_att 1``, the CLI's default);
* ``SDNet``: ``dsnet`` (dsnet_t2.py:119-321) on DenseNet-121 with the
  original ``piramidNet`` and the 17x17 correlation at 1/8 divided by the
  channel count.

Both take NCHW images and return a dict of NCHW ``seg1``, ``disp1``,
``seg2``, ``disp2``. In train mode every BatchNorm normalises by the batch's
statistics and the trunk runs once a view (each view its own statistics); in
eval mode by the running statistics, the views stacked in one batch. Running
statistics are not updated: the comparison reads the loss, the gradients and
the parameters. ``build(net, labels)`` makes one from a configuration's
``-net``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .correlation import correlation

POOLS = (128, 64, 32, 16, 8)  # the pyramid's pool sizes, branch k of tap t: POOLS[t + k]
DENSENET121 = ((6, 12, 24, 16), 32, 64)  # blocks, growth rate, first features
BN_EPS = 1e-5


def nearest(x: torch.Tensor, hw) -> torch.Tensor:
    hw = (int(hw[0]), int(hw[1]))
    return x if tuple(x.shape[-2:]) == hw else F.interpolate(x, size=hw, mode="nearest")


def bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    hw = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[-2:]) == hw:
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def up(x: torch.Tensor, factor: int) -> torch.Tensor:
    return nearest(x, (x.shape[-2] * factor, x.shape[-1] * factor))


class BN(nn.BatchNorm2d):
    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS)

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def conv(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Conv2d:
    """A bias-free 'same' convolution of an odd kernel at stride 1."""
    return nn.Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2, dilation=dilation, bias=False)


class ConvBN(nn.Module):
    """conv, then BatchNorm and ReLU where asked (convbn, dsnet_t2.py:16-46)."""

    def __init__(self, cin, cout, k=3, dilation=1, bn=True, relu=False, name="conv"):
        super().__init__()
        self.name = name
        self.add_module(name, conv(cin, cout, k, dilation))
        self.bn = BN(cout) if bn else None
        self.relu = relu

    def forward(self, x):
        x = getattr(self, self.name)(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class UpConvBN(nn.Module):
    """deconvbn at stride 2 (dsnet_t2.py:48-77) with 'SAME' padding: the
    input dilated by two, padded by (2, 1) on each axis and correlated with
    the kernel as stored, (O, I, 3, 3); BatchNorm, ReLU. Output 2H x 2W."""

    def __init__(self, cin, cout):
        super().__init__()
        self.deconv = nn.Conv2d(cin, cout, 3, bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        b, c, h, w = x.shape
        z = x.new_zeros(b, c, 2 * h - 1, 2 * w - 1)
        z[:, :, ::2, ::2] = x
        y = F.conv2d(F.pad(z, (2, 1, 2, 1)), self.deconv.weight)
        return F.relu(self.bn(y))


class DownUp(nn.Module):
    """conv2DownUp (dsnet_t2.py:80-117): three convbn+ReLU, then three
    (two without ``last``) 'deconvs' at stride 1, which are convbn+ReLU too,
    with residual adds."""

    def __init__(self, cin, cout, k=3, last=True):
        super().__init__()
        self.c1 = ConvBN(cin, cout, k, relu=True)
        self.c2 = ConvBN(cout, cout, k, relu=True)
        self.c3 = ConvBN(cout, cout, k, relu=True)
        self.d3 = ConvBN(cout, cout, k, relu=True, name="deconv")
        self.d4 = ConvBN(cout, cout, k, relu=True, name="deconv")
        self.d5 = ConvBN(cout, cout, k, relu=True, name="deconv") if last else None

    def forward(self, x):
        x1 = self.c1(x)
        x2 = self.c2(x1)
        y = self.d4(x2 + self.d3(self.c3(x2)))
        y = x1 + y
        return y if self.d5 is None else self.d5(y)


class Head(nn.Module):
    """A bare output convolution (the ConvTranspose2dSame heads)."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = conv(cin, cout, k)

    def forward(self, x):
        return self.conv(x)


def conv1x1_relu(cin, cout):
    return ConvBN(cin, cout, 1, bn=False, relu=True)


# ---------------------------------------------------------------------------
# DenseNet-121 and the pyramids
# ---------------------------------------------------------------------------


class DenseLayer(nn.Module):
    def __init__(self, cin, growth):
        super().__init__()
        self.norm1 = BN(cin)
        self.conv1 = nn.Conv2d(cin, 4 * growth, 1, bias=False)
        self.norm2 = BN(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x):
        y = self.conv2(F.relu(self.norm2(self.conv1(F.relu(self.norm1(x))))))
        return torch.cat([x, y], 1)


class Transition(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm = BN(cin)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        return self.conv(F.relu(self.norm(x)))


class DenseNet(nn.Module):
    """torchvision's DenseNet-121 features, five taps: conv0 (before norm0,
    /2), each transition before its pool (/4, /8, /16), relu(norm5) (/32)."""

    def __init__(self, cin=3):
        super().__init__()
        blocks, growth, c = DENSENET121
        self.conv0 = nn.Conv2d(cin, c, 7, stride=2, padding=3, bias=False)
        self.norm0 = BN(c)
        self.taps = [c]
        for i, n in enumerate(blocks):
            block = nn.Sequential()
            for j in range(n):
                block.add_module(f"denselayer{j + 1}", DenseLayer(c + j * growth, growth))
            self.add_module(f"denseblock{i + 1}", block)
            c += n * growth
            if i < len(blocks) - 1:
                self.add_module(f"transition{i + 1}", Transition(c, c // 2))
                c //= 2
                self.taps.append(c)
        self.norm5 = BN(c)
        self.taps.append(c)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.conv0(x)
        taps = [x]
        x = F.max_pool2d(F.relu(self.norm0(x)), 3, 2, padding=1)
        for i in range(4):
            x = getattr(self, f"denseblock{i + 1}")(x)
            if i < 3:
                x = getattr(self, f"transition{i + 1}")(x)
                taps.append(x)
                x = F.avg_pool2d(x, 2, 2)
        taps.append(F.relu(self.norm5(x)))
        return taps


class Pyramid(nn.Module):
    """DenseNet-121 and average-pool branches on some taps: branch k of tap
    t pools by POOLS[t + k] (at most the map's size), convbn(32)+ReLU, and is
    resized back bilinearly; an enriched tap is the tap and its branches.
    ``enrich``: (tap, branch name, branches). Returns the taps, then the
    enriched taps from the last to the first."""

    def __init__(self, enrich):
        super().__init__()
        self.backbone = DenseNet()
        self.enrich = enrich
        for t, name, n in enrich:
            for k in range(n):
                self.add_module(f"{name}_{k}", ConvBN(self.backbone.taps[t], 32, 3, relu=True))

    def forward(self, x):
        taps = self.backbone(x)
        out = []
        for t, name, n in self.enrich:
            m = taps[t]
            h, w = m.shape[-2:]
            maps = [m]
            for k in range(n):
                p = min(POOLS[t + k], h, w)
                maps.append(bilinear(getattr(self, f"{name}_{k}")(F.avg_pool2d(m, p, p)), (h, w)))
            out.append(torch.cat(maps, 1))
        return taps + out[::-1]


def views(trunk: nn.Module, a: torch.Tensor, b: torch.Tensor):
    """The trunk over both views: once a view in train mode, stacked in eval."""
    if trunk.training:
        return trunk(a), trunk(b)
    both = trunk(torch.cat([a, b]))
    n = a.shape[0]
    return [t[:n] for t in both], [t[n:] for t in both]


def cost_volume(a, b, patch, normalize):
    out = correlation(a, b, patch)
    return out / a.shape[1] if normalize else out


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------


class SegHead(nn.Module):
    """segNet (dsnet_t2.py:915-938)."""

    def __init__(self, cin, labels):
        super().__init__()
        self.conv1d_1 = conv1x1_relu(cin, 64)
        self.cdu1 = DownUp(64, 32)
        self.conv1d_2 = conv1x1_relu(33, 32)
        self.cdu2 = DownUp(32, 32, last=False)
        self.out = Head(32, labels, 3)

    def forward(self, x, full_hw, skip):
        x = self.cdu1(self.conv1d_1(up(x, 2)))
        x1 = up(x, 2)
        s = self.out(self.cdu2(self.conv1d_2(torch.cat([nearest(x, skip.shape[-2:]), skip], 1))))
        return x, x1, nearest(s, full_hw)


class Flagship(nn.Module):
    """minidsnetExt with 1dcorr, aspp 0 and the attention gates."""

    def __init__(self, labels=2):
        super().__init__()
        self.features = Pyramid(((0, "branch0", 5), (1, "branch1", 4), (2, "branch2", 3)))
        t = self.features.backbone.taps
        c4, c_py1 = t[4], t[1] + 4 * 32
        self.conv2d_ba = ConvBN(3, 4, 5, dilation=2, relu=True)
        self.segNet = SegHead(2 * c4, labels)
        self.corrConv2d = conv1x1_relu(17, 128)
        self.cdu3 = DownUp(32, 128)
        self.cdu4 = DownUp(256, 64)
        self.conv1d_2 = conv1x1_relu(65, 64)
        self.cdu5 = DownUp(64, 64, 5, last=False)
        self.dispoutConv = Head(64, 1, 5)
        self.conv1d_4 = conv1x1_relu(2 * c_py1, 128)
        self.cdu6 = DownUp(128, 64)
        self.cdu7 = DownUp(128, 64)
        self.conv1d_at_d = ConvBN(64, 1, 1, bn=False)
        self.cdu8 = DownUp(32, 64)
        self.cdu9 = DownUp(128, 64)
        self.conv1d_at_s = ConvBN(64, 1, 1, bn=False)
        self.cdu10 = DownUp(128, 64)
        self.conv1d_5 = conv1x1_relu(65, 32)
        self.cdu11 = DownUp(32, 32, last=False)
        self.cdu11_out = Head(32, labels, 3)

    def forward(self, left, right) -> Dict[str, torch.Tensor]:
        full = left.shape[-2:]
        a, b = views(self.features, left, right)
        xl = self.conv2d_ba(left)
        x, x1, seg1 = self.segNet(torch.cat([a[4], b[4]], 1), full, xl[:, 0:1])
        y = self.corrConv2d(cost_volume(a[5], b[5], (1, 17), False))
        y = self.cdu4(torch.cat([bilinear(self.cdu3(x1), y.shape[-2:]), y], 1))
        y2 = up(y, 8)
        d = self.conv1d_2(torch.cat([y2, bilinear(xl[:, 2:3], y2.shape[-2:])], 1))
        disp = bilinear(self.dispoutConv(self.cdu5(d)), full)
        s2 = self.cdu6(self.conv1d_4(torch.cat([a[6], b[6]], 1)))
        hw = s2.shape[-2:]
        s2_d = self.cdu7(torch.cat([s2, nearest(y, hw)], 1))
        at_d = torch.sigmoid(self.conv1d_at_d(s2_d))
        x3 = nearest(self.cdu8(x1), hw)
        s2_s = self.cdu9(torch.cat([s2, x3], 1))
        at_s = torch.sigmoid(self.conv1d_at_s(s2_s))
        s2 = self.cdu10(torch.cat([s2_d * at_s, s2_s * at_d], 1))
        skip = xl[:, 1:2]
        s2 = torch.cat([nearest(s2, skip.shape[-2:]), skip], 1)
        seg2 = self.cdu11_out(self.cdu11(self.conv1d_5(s2)))
        return {"seg1": seg1, "disp1": disp, "seg2": seg2, "disp2": disp}


class SDNet(nn.Module):
    """dsnet: the 17x17 correlation divided by C, log-softmaxed seg heads,
    seg2 = 0.9 s2 + 0.1 seg1 and disp2 = 0.8 d2 + 0.2 disp1."""

    def __init__(self, labels=2):
        super().__init__()
        self.features = Pyramid(((0, "branch0", 5), (2, "branch1", 3)))
        t = self.features.backbone.taps
        c0, c1, c4, c_py0 = t[0], t[1], t[4], t[0] + 5 * 32
        for k in (1, 2, 3):
            self.add_module(f"conv2d_ba{k}", ConvBN(3, 1, 5, dilation=2, relu=True))
        self.conv1d_1 = conv1x1_relu(2 * c4, 64)
        self.cdu1 = DownUp(64, 32)
        self.cdu2 = DownUp(32, 32, last=False)
        self.cdu2_out = Head(32, labels, 3)
        self.corrConv2d = conv1x1_relu(289, 128)
        self.cdu3 = DownUp(32, 128)
        self.cdu4 = DownUp(256, 64)
        self.conv1d_2 = conv1x1_relu(65, 64)
        self.cdu5 = DownUp(64, 64, 5, last=False)
        self.dispoutConv = Head(64, 1, 5)
        self.conv1d_3 = conv1x1_relu(96, 64)
        self.cdu6 = DownUp(64, 64, 5)
        self.conv1d_4 = conv1x1_relu(64 + c1, 64)
        self.deconv_ba1 = UpConvBN(64, 32)
        self.conv1d_5 = conv1x1_relu(32 + c0, 32)
        self.deconv_ba2 = UpConvBN(32, 32)
        self.conv1d_6 = conv1x1_relu(33, 32)
        self.cdu7 = DownUp(32, 32, 5, last=False)
        self.branchConv = Head(32, labels, 5)
        self.conv1d_9 = conv1x1_relu(2 * c_py0, 128)
        self.cdu8 = DownUp(32, 64)
        self.cdu9 = DownUp(256, 64)
        self.conv1d_8 = conv1x1_relu(65, 64)
        self.cdu10 = DownUp(64, 64, 5, last=False)
        self.cdu10_out = Head(64, 1, 5)

    def forward(self, left, right) -> Dict[str, torch.Tensor]:
        full = left.shape[-2:]
        a, b = views(self.features, left, right)
        a0, a1 = a[0], a[1]
        xl2, xl1, xl3 = (getattr(self, f"conv2d_ba{k}")(left) for k in (1, 2, 3))
        x = self.cdu1(self.conv1d_1(up(torch.cat([a[4], b[4]], 1), 2)))
        x1 = up(x, 2)
        seg1 = F.log_softmax(bilinear(up(self.cdu2_out(self.cdu2(x1)), 8), full), 1)
        y = self.corrConv2d(cost_volume(a[5], b[5], (17, 17), True))
        y = self.cdu4(torch.cat([bilinear(self.cdu3(x1), y.shape[-2:]), y], 1))
        y2 = up(y, 8)
        d = self.conv1d_2(torch.cat([y2, bilinear(xl2, y2.shape[-2:])], 1))
        disp1 = bilinear(self.dispoutConv(self.cdu5(d)), full)
        y3 = up(y, 2)
        xx = self.cdu6(self.conv1d_3(torch.cat([bilinear(up(x, 4), y3.shape[-2:]), y3], 1)))
        x3 = self.deconv_ba1(self.conv1d_4(torch.cat([bilinear(xx, a1.shape[-2:]), a1], 1)))
        xx = self.deconv_ba2(self.conv1d_5(torch.cat([bilinear(x3, a0.shape[-2:]), a0], 1)))
        s2 = self.branchConv(self.cdu7(self.conv1d_6(
            torch.cat([xx, bilinear(xl1, xx.shape[-2:])], 1))))
        seg2 = 0.9 * bilinear(F.log_softmax(s2, 1), full) + 0.1 * seg1
        y4 = self.conv1d_9(torch.cat([a[6], b[6]], 1))
        yy = torch.cat([y4, bilinear(up(y, 4), y4.shape[-2:])], 1)
        y5 = self.cdu8(x3)
        yy = up(self.cdu9(torch.cat([y5, bilinear(yy, y5.shape[-2:])], 1)), 2)
        d2 = self.cdu10_out(self.cdu10(self.conv1d_8(
            torch.cat([yy, bilinear(xl3, yy.shape[-2:])], 1))))
        disp2 = 0.8 * bilinear(d2, full) + 0.2 * disp1
        return {"seg1": seg1, "disp1": disp1, "seg2": seg2, "disp2": disp2}


NETS = {"sdnet_mini_ext": Flagship, "sdnet": SDNet}


def _added(net: str):
    """A net added after these two: the module ``net_<net>.py`` beside this
    one, with ``build(labels)`` and ``corr_sites(batch, height, width)``."""
    name = f"{__package__}.net_{net}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"the reference has no net {net!r}: one of {sorted(NETS)}, or a "
                         f"module net_{net}.py") from None


def build(net: str, labels: int) -> nn.Module:
    return NETS[net](labels) if net in NETS else _added(net).build(labels)


def corr_sites(net: str, batch: int, height: int, width: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(kernel, (B, H, W, C)) of each correlation a forward of ``net`` runs
    on ``batch`` pairs of ``height`` x ``width``: one, at 1/8 on the
    enriched tap 2 (DenseNet-121's 256 channels and three 32-channel
    branches)."""
    if net not in NETS:
        return _added(net).corr_sites(batch, height, width)

    def eighth(n):  # conv0 (stride 2, pad 3), the max pool (3, 2, pad 1), one 2x2 pool
        return (-(-(-(-n // 2)) // 2)) // 2

    blocks, growth, c = DENSENET121
    for n in blocks[:2]:  # tap 2: after two blocks and their transitions
        c = (c + n * growth) // 2
    site = (batch, eighth(height), eighth(width), c + 3 * 32)
    return [("corr1d" if net == "sdnet_mini_ext" else "corr2d", site)]
