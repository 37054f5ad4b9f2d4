"""Import the torch reference's state dicts (``.pth``, ``.pth.tar``, ``.pt``
training checkpoints, torchvision's densenet121, a MobileNetV3-Large)
straight into the port's modules, the counterpart of the JAX package's
``utils/torch_import.py`` and ``utils/torch_import_families.py``.

The port's modules are torch modules already, so most entries are a rename
of a key. An importer is a list of entries (port name, reference keys,
transform), and it reads the same reference keys the JAX package's importer
of the same name reads, each once:

* ``copy``   -- the tensor as it is: convolutions (OIHW), Conv1d (OIk),
  BatchNorm, embeddings;
* ``deconv`` -- a stride-1 'same' ``ConvTranspose2d`` (I, O, kh, kw), which
  the port runs as a SAME convolution: flipped in space, I and O swapped
  (``deconv_as_conv_kernel``); also the stride-2 ``DeconvBN`` of the legacy
  nets and PSMNet's ``ConvTranspose3d`` (I, O, kd, kh, kw), whose
  ``SameConvTranspose2d``/``3d`` keep a conv's layout;
* ``cat``    -- several tensors concatenated along dim 0: the reference's
  four 3->1 ``conv2d_ba{0..3}`` image convs of the flagship, merged into the
  port's one 3->4 ``conv2d_ba`` in the channel order ba0, ba2, ba1, ba3
  (the forward's binding, dsnet_t2.py:1176-1179), and sdnet_mini's ba0,
  ba1.

``entries_for`` gives the configured net's entries and ``import_state_dict``
applies them to a reference dict: the one import path of every net.
``load_port_state`` fills a model from such a dict and raises unless every
parameter and BatchNorm statistic is filled exactly once with its shape, as
``models.load_jax_variables`` does. ``export_state_dict`` inverts an
importer: the reference-layout dict that imports back to a model's tensors.

Every trunk is imported (``backbone_entries``: densenet121/169/201/161 in
torchvision's style, the dilated ResNets, EfficientNet in
efficientnet_pytorch's layout, MobileNetV3-Large in cuevhv's for
``-pretrained_path``), inside the four flagship variants, the Ext_small
nets, ``sdnet_mini_ext_dlab`` (HANet's deeplabV3plus), sdnet_mini, sdnet,
sdnetv2, the warp nets and sdnet_seg; and the deeplab nets (Xception-65 or
the MobileNetV2 encoder, their ASPPs and decoders; a bare Xception-65 for
``-pretrained_path``) and PSMNet. Not imported, as the JAX package's
importers do not map them either: the multitask log-variance and
decoder-only modules (ROADMAP.md queue 1, item 11.3), a mobilenet trunk
inside a net and the Ext_small nets' ASPPs (queue 3).
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

Entry = Tuple[str, Tuple[str, ...], str]  # (port name, reference keys, transform)
DENSENET121_BLOCKS = (6, 12, 24, 16)
_BN = ("weight", "bias", "running_mean", "running_var")


def _spatial(w: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(2, w.dim()))


def deconv_as_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d/3d (I, O, k...) -> the port's conv layout (O, I,
    k...): flip the spatial dims, swap I and O."""
    return w.flip(_spatial(w)).transpose(0, 1).contiguous()


def _as_tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def _bn(port: str, ref: str) -> List[Entry]:
    return [(f"{port}.{leaf}", (f"{ref}.{leaf}",), "copy") for leaf in _BN]


def _convbn(port: str, ref: str) -> List[Entry]:
    """convbn (dsnet_t2.py:16-46): Sequential(conv2dSame, BN)."""
    return [(f"{port}.conv.weight", (f"{ref}.layers.0.c2d.weight",), "copy")] + _bn(
        f"{port}.bn", f"{ref}.layers.1")


def _deconvbn(port: str, ref: str) -> List[Entry]:
    """deconvbn (dsnet_t2.py:48-77): Sequential(ConvTranspose2dSame, BN)."""
    return [(f"{port}.deconv.weight", (f"{ref}.layers.0.ct2d.weight",), "deconv")] + _bn(
        f"{port}.bn", f"{ref}.layers.1")


def _cdu(port: str, ref: str, last: bool = True) -> List[Entry]:
    """Conv2DownUp (dsnet_t2.py:80-117): each unit is Sequential(unit, ReLU,
    Dropout), so its keys sit under index 0."""
    e = [x for name in ("c1", "c2", "c3") for x in _convbn(f"{port}.{name}", f"{ref}.{name}.0")]
    return e + [x for name in ("d3", "d4") + (("d5",) if last else ())
                for x in _deconvbn(f"{port}.{name}", f"{ref}.{name}.0")]


def _conv_plain(port: str, ref: str) -> List[Entry]:
    """conv2dSame inside a Sequential -> a bias-free ConvBN(batchnorm=False)."""
    return [(f"{port}.conv.weight", (f"{ref}.0.c2d.weight",), "copy")]


def _deconv_out(port: str, ref: str) -> List[Entry]:
    """ConvTranspose2dSame head -> ConvOut."""
    return [(f"{port}.conv.weight", (f"{ref}.ct2d.weight",), "deconv")]


def _image_convs(port: str, order: Sequence[int]) -> List[Entry]:
    """The reference's 3->1 ``conv2d_ba{i}`` convbns merged into one."""
    pre = [f"conv2d_ba{i}.0.layers" for i in order]
    return [(f"{port}.conv.weight", tuple(f"{p}.0.c2d.weight" for p in pre), "cat")] + [
        (f"{port}.bn.{leaf}", tuple(f"{p}.1.{leaf}" for p in pre), "cat") for leaf in _BN]


def _densenet(port: str, block_config: Sequence[int]) -> List[Entry]:
    """torchvision densenet keys (``features.*``) -> ``DenseNetFeatures``."""
    e = [(f"{port}.conv0.weight", ("features.conv0.weight",), "copy")]
    e += _bn(f"{port}.norm0", "features.norm0")
    for bi, n_layers in enumerate(block_config, start=1):
        for li in range(1, n_layers + 1):
            layer = f"denseblock{bi}.denselayer{li}"
            for norm, conv in (("norm1", "conv1"), ("norm2", "conv2")):
                e += _bn(f"{port}.{layer}.{norm}", f"features.{layer}.{norm}")
                e.append((f"{port}.{layer}.{conv}.weight", (f"features.{layer}.{conv}.weight",),
                          "copy"))
        if bi < len(block_config):
            e += _bn(f"{port}.transition{bi}.norm", f"features.transition{bi}.norm")
            e.append((f"{port}.transition{bi}.conv.weight",
                      (f"features.transition{bi}.conv.weight",), "copy"))
    return e + _bn(f"{port}.norm5", "features.norm5")


def ref_densenet_to_torchvision_keys(sd: Mapping[str, object]) -> Dict[str, object]:
    """The reference's densenet (models/densenet.py:150-206) keeps blocks and
    transitions in one ModuleList ``denseblock`` (even indices blocks, odd
    ones transitions) with ``conv0`` and ``norm5`` out of ``features``:
    rewrite its keys in torchvision's style."""
    out = {}
    for k, v in sd.items():
        if "num_batches_tracked" in k or k.startswith("classifier."):
            continue
        m = re.match(r"denseblock\.(\d+)\.(.*)", k)
        if m:
            idx, rest = int(m.group(1)), m.group(2)
            kind = "denseblock" if idx % 2 == 0 else "transition"
            out[f"features.{kind}{idx // 2 + 1}.{rest}"] = v
        elif k.startswith(("conv0.", "norm5.")):
            out[f"features.{k}"] = v
        else:
            out[k] = v  # features.norm0.* is in place already
    return out


def _torchvision_to_ref_densenet_keys(sd: Mapping[str, object]) -> Dict[str, object]:
    """The inverse of ``ref_densenet_to_torchvision_keys``."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"features\.(denseblock|transition)(\d+)\.(.*)", k)
        if m:
            idx = 2 * (int(m.group(2)) - 1) + (m.group(1) == "transition")
            out[f"denseblock.{idx}.{m.group(3)}"] = v
        elif k.startswith(("features.conv0.", "features.norm5.")):
            out[k[len("features."):]] = v
        else:
            out[k] = v
    return out


def _torchvision_style(sd: Mapping[str, object]) -> Dict[str, object]:
    """A densenet state dict in torchvision's key style, whichever it was
    written in (legacy dotted ``norm.1`` names included)."""
    if "features.conv0.weight" not in sd:
        sd = ref_densenet_to_torchvision_keys(sd)
    return {k.replace("norm.1", "norm1").replace("norm.2", "norm2")
            .replace("conv.1", "conv1").replace("conv.2", "conv2"): v for k, v in sd.items()}


def _apply(entries: List[Entry], sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    out = {}
    for port, refs, kind in entries:
        missing = [r for r in refs if r not in sd]
        if missing:
            raise KeyError(f"the state dict has no {missing[0]!r} (for the port's {port})")
        ts = [_as_tensor(sd[r]) for r in refs]
        if kind == "copy":
            out[port] = ts[0].clone()
        elif kind == "deconv":
            out[port] = deconv_as_conv_kernel(ts[0])
        else:
            out[port] = torch.cat(ts, dim=0)
    return out


_TRUNK_REF = "resnet_features.resnet_features."  # piramidNet2's trunk in a reference dict


def _resnet(port: str, ref: str, trunk) -> List[Entry]:
    """The reference's dilated ResNet (models/resnet_deeplab.py:45-170: a 7x7
    ``conv1``/``bn1`` stem) or HANet's ResNet3X3 (Resnet.py:137-163: the
    ``layer0`` Sequential, convs at 0/3/6 and BNs at 1/4/7) -> the port's
    ``ResNetDeeplabFeatures``; a projected residual is ``downsample.0/1``."""
    if trunk.stem == "3x3x3":
        e = []
        for i, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))):
            e.append((f"{port}.{conv}.weight", (f"{ref}layer0.{3 * i}.weight",), "copy"))
            e += _bn(f"{port}.{bn}", f"{ref}layer0.{3 * i + 1}")
    else:
        e = [(f"{port}.conv1.weight", (f"{ref}conv1.weight",), "copy")] + _bn(f"{port}.bn1",
                                                                            f"{ref}bn1")
    for li, names in enumerate(trunk.names, start=1):
        for bi, name in enumerate(names):
            pre, block = f"{ref}layer{li}.{bi}", getattr(trunk, name)
            for k in (1, 2, 3):
                e.append((f"{port}.{name}.conv{k}.weight", (f"{pre}.conv{k}.weight",), "copy"))
                e += _bn(f"{port}.{name}.bn{k}", f"{pre}.bn{k}")
            if block.downsample:
                e.append((f"{port}.{name}.down_conv.weight", (f"{pre}.downsample.0.weight",),
                          "copy"))
                e += _bn(f"{port}.{name}.down_bn", f"{pre}.downsample.1")
    return e


def _efficientnet(port: str, ref: str, trunk) -> List[Entry]:
    """efficientnet_pytorch's layout (``_conv_stem``, ``_blocks.i``,
    ``_conv_head``; models/dsnet_t2.py:1956) -> ``EfficientNetFeatures``."""
    e = [(f"{port}.stem.weight", (f"{ref}_conv_stem.weight",), "copy")]
    e += _bn(f"{port}.stem_bn", f"{ref}_bn0")
    for i in range(trunk.n_blocks):
        pre, mine = f"{ref}_blocks.{i}", f"{port}.block{i}"
        if getattr(trunk, f"block{i}").has_expand:
            e.append((f"{mine}.expand.weight", (f"{pre}._expand_conv.weight",), "copy"))
            e += _bn(f"{mine}.expand_bn", f"{pre}._bn0")
        e.append((f"{mine}.dw.weight", (f"{pre}._depthwise_conv.weight",), "copy"))
        e += _bn(f"{mine}.dw_bn", f"{pre}._bn1")
        for ours, theirs in (("se_reduce", "_se_reduce"), ("se_expand", "_se_expand")):
            e += [(f"{mine}.{ours}.{leaf}", (f"{pre}.{theirs}.{leaf}",), "copy")
                  for leaf in ("weight", "bias")]
        e.append((f"{mine}.project.weight", (f"{pre}._project_conv.weight",), "copy"))
        e += _bn(f"{mine}.project_bn", f"{pre}._bn2")
    e.append((f"{port}.head.weight", (f"{ref}_conv_head.weight",), "copy"))
    return e + _bn(f"{port}.head_bn", f"{ref}_bn1")


def _mobilenetv3(port: str, ref: str, trunk) -> List[Entry]:
    """cuevhv's mobilenetv3.pytorch layout (``features.0`` the stem,
    ``features.1..15`` the InvertedResiduals, models/mobilenetv3.py:91-131;
    the JAX package's ``import_mobilenetv3_backbone``) ->
    ``MobileNetV3LargeFeatures``. A block whose expansion is 1 lists dw,
    bn, act, SE, pw-lin, bn; any other pw, bn, act, dw, bn, SE, act,
    pw-lin, bn."""
    from ..models.mobilenetv3 import LARGE_CFG

    e = [(f"{port}.stem.weight", (f"{ref}features.0.0.weight",), "copy")]
    e += _bn(f"{port}.stem_bn", f"{ref}features.0.1")
    for i in range(1, len(LARGE_CFG) + 1):
        pre, mine, block = f"{ref}features.{i}.conv", f"{port}.block{i}", getattr(trunk, f"block{i}")
        idx = dict(dw=3, dw_bn=4, se=5, pw_lin=7, pw_lin_bn=8) if block.expand else dict(
            dw=0, dw_bn=1, se=3, pw_lin=4, pw_lin_bn=5)
        if block.expand:
            e.append((f"{mine}.pw.weight", (f"{pre}.0.weight",), "copy"))
            e += _bn(f"{mine}.pw_bn", f"{pre}.1")
        e.append((f"{mine}.dw.weight", (f"{pre}.{idx['dw']}.weight",), "copy"))
        e += _bn(f"{mine}.dw_bn", f"{pre}.{idx['dw_bn']}")
        if block.se is not None:  # SE: Linear, ReLU, Linear, h_sigmoid
            e += [(f"{mine}.se.{fc}.{leaf}", (f"{pre}.{idx['se']}.fc.{k}.{leaf}",), "copy")
                  for fc, k in (("fc1", 0), ("fc2", 2)) for leaf in ("weight", "bias")]
        e.append((f"{mine}.pw_lin.weight", (f"{pre}.{idx['pw_lin']}.weight",), "copy"))
        e += _bn(f"{mine}.pw_lin_bn", f"{pre}.{idx['pw_lin_bn']}")
    return e


def backbone_entries(trunk, port: str = "features.backbone", ref: str = _TRUNK_REF) -> List[Entry]:
    """The entries of a port trunk module (by its class) under the port
    prefix ``port``, its reference keys under ``ref``: densenet121/169/201/
    161 (torchvision's ``features.*`` style), the dilated ResNets,
    EfficientNet, MobileNetV3-Large."""
    from ..models.densenet import DenseNetFeatures
    from ..models.efficientnet import EfficientNetFeatures
    from ..models.mobilenetv3 import MobileNetV3LargeFeatures
    from ..models.resnet_deeplab import ResNetDeeplabFeatures

    if isinstance(trunk, DenseNetFeatures):
        blocks = tuple(len(getattr(trunk, f"denseblock{i + 1}")) for i in range(trunk.n_blocks))
        return [(p, tuple(ref + r for r in refs), kind) for p, refs, kind in _densenet(port, blocks)]
    maker = {ResNetDeeplabFeatures: _resnet, EfficientNetFeatures: _efficientnet,
             MobileNetV3LargeFeatures: _mobilenetv3}[type(trunk)]
    return maker(port, ref, trunk)


def _trunk_entries(trunk, branches) -> List[Entry]:
    """piramidNet2 / piramidNet: the trunk under
    ``resnet_features.resnet_features`` and the branch convbns (Sequential:
    0 AvgPool, 1 convbn, 2 ReLU)."""
    entries = backbone_entries(trunk)
    for tap, n in branches:
        for k in range(n):
            entries += _convbn(f"features.branch{tap}_{k}", f"resnet_features.branch{tap}_{k}.1")
    return entries


def _trunk_view(sd: Mapping[str, object]) -> Dict[str, object]:
    """A reference dict with its densenet trunk's keys (if it has one) in
    torchvision's style, under their full prefix; every other key as it
    is."""
    pre = _TRUNK_REF
    bb = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    if not any(k.startswith(("features.conv0.", "conv0.")) for k in bb):
        return dict(sd)
    rest = {k: v for k, v in sd.items() if not k.startswith(pre)}
    rest.update((pre + k, v) for k, v in _torchvision_style(bb).items())
    return rest


def _aspp_4(trunk) -> List[Entry]:
    """The ResNet trunks' ASPP over tap 4 (``aspp_4``, dsnet_t2.py:957-960)."""
    from ..models.resnet_deeplab import ResNetDeeplabFeatures

    return _aspp("aspp_4", "aspp_4") if isinstance(trunk, ResNetDeeplabFeatures) else []


def ext_entries(trunk, use_att: bool = True, conv_deconv_out: int = 0,
                ablation: Sequence[str] = (), aspp_mod: int = 0, hanet: bool = False,
                variant: str = "ext", hanet_embedding: bool = False) -> List[Entry]:
    """The entries of minidsnetExt and its variants on the port trunk
    ``trunk`` (the JAX package's ``import_minidsnet_ext``; a ResNet trunk
    adds ``aspp_4``). ``variant``: "ext"; "v2" (one self-gate
    ``conv1d_at``); "piramid" (the flagship's modules); "piramid_res"
    (plain ``dispoutConv`` and ``convSegOut`` heads, an unwrapped
    ``Conv2DownUp11``). ``hanet_embedding``: HANet's learned position
    embedding (is_encoding 0)."""
    e = _trunk_entries(trunk, ((0, 5), (1, 4), (2, 3)))
    e += _image_convs("conv2d_ba", (0, 2, 1, 3))
    e += _conv_plain("segNet.conv1d_1", "segNet.conv1d_1")
    e += _cdu("segNet.cdu1", "segNet.Conv2DownUp1")
    e += _conv_plain("segNet.conv1d_2", "segNet.conv1d_2")
    e += _cdu("segNet.cdu2", "segNet.Conv2DownUp2.0", last=False)
    e += _deconv_out("segNet.out", "segNet.Conv2DownUp2.1")
    e += _conv_plain("corrConv2d", "corrConv2d")
    e += _cdu("cdu3", "Conv2DownUp3")
    e += _cdu("cdu4", "Conv2DownUp4")
    e += _conv_plain("conv1d_2", "conv1d_2")
    e += _cdu("cdu5", "Conv2DownUp5", last=False)
    if variant == "piramid_res":  # a plain conv2dSame head (dsnet_t2.py:2293)
        e.append(("dispoutConv.conv.weight", ("dispoutConv.c2d.weight",), "copy"))
    else:
        e += _deconv_out("dispoutConv", "dispoutConv")
    e += _conv_plain("conv1d_4", "conv1d_4")  # conv1d_3: built, never used by the forward
    e += _cdu("cdu6", "Conv2DownUp6")
    if "no_dec3" not in ablation:
        if variant == "v2":
            e += _cdu("cdu7", "Conv2DownUp7") + _cdu("cdu9", "Conv2DownUp9")
            e += _conv_plain("conv1d_at", "conv1d_at")
        elif use_att:
            e += _cdu("cdu7", "Conv2DownUp7") + _cdu("cdu9", "Conv2DownUp9")
            e += _conv_plain("conv1d_at_d", "conv1d_at_d")
            e += _conv_plain("conv1d_at_s", "conv1d_at_s")
        e += _cdu("cdu8", "Conv2DownUp8")
    e += _cdu("cdu10", "Conv2DownUp10")
    e += _conv_plain("conv1d_5", "conv1d_5")
    if aspp_mod in (1, 2):
        e += _aspp("aspp", "aspp")
    e += _aspp_4(trunk)
    if hanet:
        e += _hanet("hanet_last", "hanet_last", hanet_embedding)
    if conv_deconv_out:
        e += _conv_deconv_out(conv_deconv_out)
    elif variant == "piramid_res":
        e += _cdu("cdu11", "Conv2DownUp11", last=False)
        e.append(("cdu11_out.conv.weight", ("convSegOut.c2d.weight",), "copy"))
    else:
        e += _cdu("cdu11", "Conv2DownUp11.0", last=False)
        e += _deconv_out("cdu11_out", "Conv2DownUp11.1")
    return e


def _conv_deconv_out(mode: int) -> List[Entry]:
    """convDeconvOut 1/2: ``Conv2DownUp11``'s body, the plain ``convOutput2``
    and (mode 2) the transposed ``convOutput``."""
    e = _cdu("cdu11", "Conv2DownUp11.0", last=False)
    e.append(("convOutput2.weight", ("convOutput2.c2d.weight",), "copy"))
    return e + (_deconv_out("convOutput", "convOutput") if mode == 2 else [])


def _aspp(port: str, ref: str) -> List[Entry]:
    """The dsnet-flavour ASPP (models/aspp.py:34-112)."""
    e = []
    for i in (1, 2, 3, 4):
        e.append((f"{port}.aspp{i}_conv.weight", (f"{ref}.aspp{i}.atrous_conv.weight",), "copy"))
        e += _bn(f"{port}.aspp{i}_bn", f"{ref}.aspp{i}.bn")
    e.append((f"{port}.gp_conv.weight", (f"{ref}.global_avg_pool.1.weight",), "copy"))
    e += _bn(f"{port}.gp_bn", f"{ref}.global_avg_pool.2")
    e.append((f"{port}.proj_conv.weight", (f"{ref}.conv1.weight",), "copy"))
    e += _bn(f"{port}.proj_bn", f"{ref}.bn1")
    return e


def _hanet(port: str, ref: str, embedding: bool) -> List[Entry]:
    """HANet_Conv (models_hanet/HANet.py:9-128), three layers."""
    e = [(f"{port}.att1_conv.weight", (f"{ref}.attention_first.0.weight",), "copy")]
    e += _bn(f"{port}.att1_bn", f"{ref}.attention_first.1")
    for mine, theirs in (("att2_conv", "attention_second.0"), ("att3_conv", "attention_third.0")):
        e += [(f"{port}.{mine}.{leaf}", (f"{ref}.{theirs}.{leaf}",), "copy")
              for leaf in ("weight", "bias")]
    e += _bn(f"{port}.att2_bn", f"{ref}.attention_second.1")
    if embedding:  # PosEmbedding1D (is_encoding 0, PosEmbedding.py:88-120)
        e.append((f"{port}.pos_emb1d_2nd.weight", (f"{ref}.pos_emb1d_2nd.pos_embedding.weight",),
                  "copy"))
    return e


def _head1_segnet() -> List[Entry]:
    e = _conv_plain("segNet.conv1d_1", "segNet.conv1d_1")
    e += _cdu("segNet.cdu1", "segNet.Conv2DownUp1")
    e += _conv_plain("segNet.conv1d_2", "segNet.conv1d_2")
    e += _cdu("segNet.cdu2", "segNet.Conv2DownUp2.0", last=False)
    return e + _deconv_out("segNet.out", "segNet.Conv2DownUp2.1")


def _disp_head() -> List[Entry]:
    e = _conv_plain("corrConv2d", "corrConv2d")
    e += _cdu("cdu3", "Conv2DownUp3") + _cdu("cdu4", "Conv2DownUp4")
    e += _conv_plain("conv1d_2", "conv1d_2")
    e += _cdu("cdu5", "Conv2DownUp5", last=False)
    return e + _deconv_out("dispoutConv", "dispoutConv")


def minidsnet_entries(trunk) -> List[Entry]:
    """minidsnet, ``sdnet_mini`` (the JAX package's ``import_minidsnet``):
    the original piramidNet, ba0 and ba1 merged (ba2, ba3 and conv1d_3 are
    built but unused by the forward)."""
    e = _trunk_entries(trunk, ((0, 5), (1, 3)))
    e += _image_convs("conv2d_ba", (0, 1))
    return e + _head1_segnet() + _disp_head()


def _dsnet_tail() -> List[Entry]:
    """The cascade shared by dsnet and dsnetv2 after the disparity head."""
    e = _conv_plain("conv1d_3", "conv1d_3") + _cdu("cdu6", "Conv2DownUp6")
    e += _conv_plain("conv1d_4", "conv1d_4")
    e += _deconvbn("deconv_ba1", "conv2DT_BA1.0")
    e += _conv_plain("conv1d_5", "conv1d_5")
    e += _deconvbn("deconv_ba2", "conv2DT_BA2.0")
    e += _conv_plain("conv1d_6", "conv1d_6")
    e += _cdu("cdu7", "Conv2DownUp7", last=False)
    e += _deconv_out("branchConv", "branchConv")
    e += _conv_plain("conv1d_9", "conv1d_9")  # conv1d_7: built, never used
    e += _cdu("cdu8", "Conv2DownUp8") + _cdu("cdu9", "Conv2DownUp9")
    e += _conv_plain("conv1d_8", "conv1d_8")
    e += _cdu("cdu10", "Conv2DownUp10.0", last=False)
    return e + _deconv_out("cdu10_out", "Conv2DownUp10.1")


def dsnet_entries(trunk) -> List[Entry]:
    """dsnet, ``sdnet`` (the JAX package's ``import_dsnet``): head 1 inline,
    no conv2d_ba0."""
    e = _trunk_entries(trunk, ((0, 5), (1, 3)))
    for i in (1, 2, 3):
        e += _convbn(f"conv2d_ba{i}", f"conv2d_ba{i}.0")
    e += _conv_plain("conv1d_1", "conv1d_1") + _cdu("cdu1", "Conv2DownUp1")
    e += _cdu("cdu2", "Conv2DownUp2.0", last=False)
    e += _deconv_out("cdu2_out", "Conv2DownUp2.1")
    return e + _disp_head() + _dsnet_tail()


def dsnetv2_entries(trunk) -> List[Entry]:
    """dsnetv2, ``sdnetv2`` (the JAX package's ``import_dsnetv2``)."""
    e = _trunk_entries(trunk, ((0, 5), (1, 3)))
    for i in range(4):
        e += _convbn(f"conv2d_ba{i}", f"conv2d_ba{i}.0")
    return e + _head1_segnet() + _disp_head() + _dsnet_tail()


def _rcu(port: str, ref: str, use_deconv: bool) -> List[Entry]:
    """RCU (dsnet_t2_ext_small.py:43-64): c1, c2, then the deconvbn d3 or
    the convbn c3, each under Sequential index 0."""
    e = _convbn(f"{port}.c1", f"{ref}.c1.0") + _convbn(f"{port}.c2", f"{ref}.c2.0")
    if use_deconv:
        return e + _deconvbn(f"{port}.d3", f"{ref}.d3.0")
    return e + _convbn(f"{port}.c3", f"{ref}.c3.0")


def ext_small_entries(trunk, variant: str = "edge") -> List[Entry]:
    """Ext_small (``_edge``), Ext_smallv2 (``_edgev2``) and Ext_smallv0
    (``sdnet_mini_ext_small``) at aspp 0 (the JAX package's
    ``import_ext_small``): RCUs in place of the Conv2DownUps, plain
    conv2dSame output heads but the transposed ``dispoutConv``; the edge
    variant's three image convbns. conv1d_3 is built, never used."""
    use_dc = variant != "edge"
    e = _trunk_entries(trunk, ((0, 5), (1, 4), (2, 3)))
    if variant == "edge":
        for i in (0, 1, 2):
            e += _convbn(f"conv2d_ba{i}", f"conv2d_ba{i}.0")
    e += _conv_plain("segNet.conv1d_1", "segNet.conv1d_1")
    e += _rcu("segNet.cdu1", "segNet.Conv2DownUp1", use_dc)
    e += _conv_plain("segNet.conv1d_2", "segNet.conv1d_2")
    e += _rcu("segNet.cdu2", "segNet.Conv2DownUp2.0", use_dc)
    e.append(("segNet.out.weight", ("segNet.Conv2DownUp2.1.c2d.weight",), "copy"))
    e += _conv_plain("corrConv2d", "corrConv2d")
    for k in range(3, 11):
        e += _rcu(f"rcu{k}", f"Conv2DownUp{k}", use_dc)
    e += _conv_plain("conv1d_2", "conv1d_2")
    e.append(("dispoutConv.weight", ("dispoutConv.ct2d.weight",), "deconv"))
    for name in ("conv1d_4", "conv1d_at", "conv1d_5"):
        e += _conv_plain(name, name)
    e += _rcu("rcu11", "Conv2DownUp11.0", use_dc)
    e.append(("rcu11_out.weight", ("Conv2DownUp11.1.c2d.weight",), "copy"))
    return e


def _plain_conv_bn(port: str, ref: str, conv: str = "conv", bn: str = "bn") -> List[Entry]:
    """Sequential(Conv2d bias-free, Norm2d, ReLU) -> a conv and its BN."""
    return [(f"{port}.{conv}.weight", (f"{ref}.0.weight",), "copy")] + _bn(f"{port}.{bn}",
                                                                          f"{ref}.1")


def deeplabv3plus_hanet_entries(trunk, port: str = "features",
                                ref: str = "resnet_features") -> List[Entry]:
    """deeplabV3plus(return_layers=True) (models_hanet/resnet_pytorch.py:
    70-232; the JAX package's ``import_deeplabv3plus_hanet``) ->
    ``DeeplabV3PlusFeatures``: the ResNet3X3 trunk, HANet's ASPP
    (``features.0..3`` the 1x1 and atrous branches, ``img_conv`` the pooled
    one) and the 1x1 ``bot_aspp``/``bot_fine``. final1_1/final1_2/final2 are
    built, never run with return_layers."""
    e = backbone_entries(trunk, f"{port}.trunk", f"{ref}.")
    for i in range(4):
        e += _plain_conv_bn(f"{port}.aspp", f"{ref}.aspp.features.{i}", f"feat{i}_conv",
                            f"feat{i}_bn")
    e += _plain_conv_bn(f"{port}.aspp", f"{ref}.aspp.img_conv", "img_conv", "img_bn")
    return e + _plain_conv_bn(f"{port}.bot_aspp", f"{ref}.bot_aspp") + _plain_conv_bn(
        f"{port}.bot_fine", f"{ref}.bot_fine")


def ext_dlab_entries(trunk, conv_deconv_out: int = 0, ablation: Sequence[str] = (),
                     hanet: bool = False, hanet_embedding: bool = False) -> List[Entry]:
    """minidsnetExt_deeplab, ``sdnet_mini_ext_dlab`` (the JAX package's
    ``import_ext_dlab``): the flagship's heads over ``deeplabv3plus_hanet_
    entries``. conv1d_3 is built, never used."""
    e = deeplabv3plus_hanet_entries(trunk) + _head1_segnet() + _disp_head()
    e += _conv_plain("conv1d_4", "conv1d_4") + _cdu("cdu6", "Conv2DownUp6")
    if "no_dec3" not in ablation:
        e += _cdu("cdu7", "Conv2DownUp7") + _cdu("cdu8", "Conv2DownUp8")
        e += _cdu("cdu9", "Conv2DownUp9")
        e += _conv_plain("conv1d_at_d", "conv1d_at_d") + _conv_plain("conv1d_at_s", "conv1d_at_s")
    e += _cdu("cdu10", "Conv2DownUp10") + _conv_plain("conv1d_5", "conv1d_5")
    if conv_deconv_out:
        e += _conv_deconv_out(conv_deconv_out)
    else:
        e += _cdu("cdu11", "Conv2DownUp11.0", last=False)
        e += _deconv_out("cdu11_out", "Conv2DownUp11.1")
    if hanet:
        e += _hanet("hanet_last", "hanet_last", hanet_embedding)
    return e


def minidsnet_divide_entries(trunk, variant: str = "divide") -> List[Entry]:
    """The warp nets (the JAX package's ``import_minidsnet_divide``):
    piramidNet2 with its fourth tap (``branch3_*``), ``conv2d_ba1``, the
    SmallsegNet head, the disparity decoder and the attention head:
    ``Conv2DownUp7`` + ``conv1d_at_d``, or for "soft" a Sequential of a
    Conv2DownUp and a transposed output conv. conv2d_ba0/2/3, conv1d_3 and
    segNetB2 are built, never used."""
    e = _trunk_entries(trunk, ((0, 5), (1, 4), (2, 3), (3, 2)))
    e += _convbn("conv2d_ba1", "conv2d_ba1.0")
    e += _head1_segnet() + _disp_head()
    if variant == "soft":
        return e + _cdu("cdu7", "Conv2DownUp7.0", last=False) + _deconv_out("cdu7_out",
                                                                          "Conv2DownUp7.1")
    return e + _cdu("cdu7", "Conv2DownUp7") + _conv_plain("conv1d_at_d", "conv1d_at_d")


def seg_dsnet_entries(trunk) -> List[Entry]:
    """seg_dsnet, ``sdnet_seg`` (the JAX package's ``import_seg_dsnet``):
    minidsnet's piramidNet, ``conv2d_ba0``/``1``, the shared segNet, the
    disparity decoder. conv2d_ba2/3 and conv1d_3 are built, never used."""
    e = _trunk_entries(trunk, ((0, 5), (1, 3)))
    e += _convbn("conv2d_ba0", "conv2d_ba0.0") + _convbn("conv2d_ba1", "conv2d_ba1.0")
    return e + _head1_segnet() + _disp_head()


def _separable(port: str, ref: str) -> List[Entry]:
    """SeparableConv2d (models_deeplab/common.py:25-52): ``block.depthwise``
    (C, 1, k, k), ``block.pointwise`` and their BatchNorms."""
    e = [(f"{port}.{conv}.weight", (f"{ref}.block.{conv}.weight",), "copy")
         for conv in ("depthwise", "pointwise")]
    return e + _bn(f"{port}.bn_depth", f"{ref}.block.bn_depth") + _bn(f"{port}.bn_point",
                                                                       f"{ref}.block.bn_point")


def _weight(port: str, ref: str) -> List[Entry]:
    return [(f"{port}.weight", (f"{ref}.weight",), "copy")]


def _conv_bias(port: str, ref: str) -> List[Entry]:
    return _weight(port, ref) + [(f"{port}.bias", (f"{ref}.bias",), "copy")]


def xception65_entries(encoder, port: str = "encoder", ref: str = "encoder.") -> List[Entry]:
    """Xception65 (models_deeplab/xception.py:49-135; the stereo net's is the
    same, its taps forward-only) under the reference prefix ``ref``: the
    JAX package's ``import_xception65``."""
    e = _weight(f"{port}.conv1", f"{ref}conv1") + _bn(f"{port}.bn1", f"{ref}bn1")
    e += _weight(f"{port}.conv2", f"{ref}conv2") + _bn(f"{port}.bn2", f"{ref}bn2")
    for i in range(1, 22):
        pre, mine = f"{ref}block{i}", f"{port}.block{i}"
        for k in (1, 2, 3):
            e += _separable(f"{mine}.sep{k}", f"{pre}.sep_conv{k}")
        if getattr(encoder, f"block{i}").skip == "conv":
            e += _weight(f"{mine}.skip_conv", f"{pre}.conv") + _bn(f"{mine}.skip_bn", f"{pre}.bn")
    return e


def _mobilenetv2(port: str = "encoder", ref: str = "encoder") -> List[Entry]:
    """The deeplab MobileNetV2 encoder (models_deeplab/mobilenet.py:53-103):
    the JAX package's ``import_mobilenetv2_encoder``; block 0 has no
    expansion."""
    from ..models.deeplab import MOBILENETV2_CFG

    e = _weight(f"{port}.stem", f"{ref}.conv") + _bn(f"{port}.stem_bn", f"{ref}.bn")
    for i, (*_, ratio, _) in enumerate(MOBILENETV2_CFG):
        pre, mine = f"{ref}.block{i}", f"{port}.block{i}"
        parts = (("expand", "ebn", "expand"),) if ratio != 1 else ()
        for conv, bn, theirs in parts + (("dw", "dbn", "depthwise"), ("proj", "pbn", "project")):
            e += _weight(f"{mine}_{conv}", f"{pre}.{theirs}.conv") + _bn(f"{mine}_{bn}",
                                                                         f"{pre}.{theirs}.bn")
    return e


def _aspp_deeplab(spp, port: str = "spp", ref: str = "spp") -> List[Entry]:
    """ASPP (models_deeplab/spp.py:34-77) or MobileASPP (:80-108, no atrous
    branches): the JAX package's ``import_aspp_deeplab``/``import_mobile_aspp``."""
    e = _weight(f"{port}.gap_conv", f"{ref}.image_pooling.conv")
    e += _bn(f"{port}.gap_bn", f"{ref}.image_pooling.bn")
    e += _weight(f"{port}.aspp0_conv", f"{ref}.aspp0.conv") + _bn(f"{port}.aspp0_bn", f"{ref}.aspp0.bn")
    if hasattr(spp, "aspp1"):
        for i in (1, 2, 3):
            e += _separable(f"{port}.aspp{i}", f"{ref}.aspp{i}")
    return e + _weight(f"{port}.proj", f"{ref}.conv") + _bn(f"{port}.proj_bn", f"{ref}.bn")


def _spp_decoder(port: str, concat_prev: bool = False) -> List[Entry]:
    """SPPDecoder (models_deeplab_mod/spp.py:131-157): the JAX package's
    ``import_spp_decoder``."""
    e = _weight(f"{port}.low_conv", f"{port}.conv") + _bn(f"{port}.low_bn", f"{port}.bn")
    if concat_prev:
        e += _weight(f"{port}.int_conv", f"{port}.conv_int_feat")
    return e + _separable(f"{port}.sep1", f"{port}.sep1") + _separable(f"{port}.sep2",
                                                                      f"{port}.sep2")


def sppnet_mono_entries(model) -> List[Entry]:
    """SPPNet ``deeplab`` (models_deeplab/net.py:82-135; the JAX package's
    ``import_sppnet_mono``): Xception-65, ASPP, decoder and logits, or the
    MobileNetV2 encoder, its ASPP (full or MobileASPP) and logits."""
    if model.enc_type == "mobilenetv2":
        e = _mobilenetv2() + _aspp_deeplab(model.spp)
    else:
        e = xception65_entries(model.encoder) + _aspp_deeplab(model.spp) + _spp_decoder("decoder")
    return e + _conv_bias("logits", "logits")


def sppnet_stereo_entries(model) -> List[Entry]:
    """SPPNet ``deeplab_mod`` (models_deeplab_mod/net.py:82-169; the JAX
    package's ``import_sppnet_stereo``)."""
    e = xception65_entries(model.encoder) + _aspp_deeplab(model.spp) + _spp_decoder("decoder")
    e += _spp_decoder("decoder2", True) + _spp_decoder("decoder3", True)
    e += _weight("conv2", "conv2") + _weight("conv3", "conv3") + _weight("corrConv", "corrConv2d.0")
    return e + [x for name in ("logits", "logits_disp", "logits_seg") for x in _conv_bias(name, name)]


def _convbn_psm(port: str, ref: str) -> List[Entry]:
    """convbn / convbn_3d (submodule.py:10-19): Sequential(conv, BN)."""
    return _weight(f"{port}.conv", f"{ref}.0") + _bn(f"{port}.bn", f"{ref}.1")


def psmnet_entries() -> List[Entry]:
    """PSMNet, stacked hourglass (stackhourglass.py:53-160; the JAX
    package's ``import_psmnet``): 3-D conv kernels as they are, the
    hourglasses' ``ConvTranspose3d`` as ``deconv``."""
    fe = "feature_extraction"
    e = []
    for i, idx in enumerate((0, 2, 4)):
        e += _convbn_psm(f"feature.first{i}", f"{fe}.firstconv.{idx}")
    for ours, theirs, n, first_down in (("l1", "layer1", 3, False), ("l2", "layer2", 16, True),
                                        ("l3", "layer3", 3, True), ("l4", "layer4", 3, False)):
        for i in range(n):
            pre, mine = f"{fe}.{theirs}.{i}", f"feature.{ours}_{i}"
            e += _convbn_psm(f"{mine}.c1", f"{pre}.conv1.0") + _convbn_psm(f"{mine}.c2", f"{pre}.conv2")
            if first_down and i == 0:
                e += _weight(f"{mine}.down", f"{pre}.downsample.0")
                e += _bn(f"{mine}.down_bn", f"{pre}.downsample.1")
    for i in (1, 2, 3, 4):
        e += _convbn_psm(f"feature.branch{i}", f"{fe}.branch{i}.1")
    e += _convbn_psm("feature.last0", f"{fe}.lastconv.0") + _weight("feature.last1", f"{fe}.lastconv.2")
    for ours, theirs in (("dres0a", "dres0.0"), ("dres0b", "dres0.2"), ("dres1a", "dres1.0"),
                         ("dres1b", "dres1.2")):
        e += _convbn_psm(ours, theirs)
    for k in (2, 3, 4):
        for c, ref in (("c1", "conv1.0"), ("c2", "conv2"), ("c3", "conv3.0"), ("c4", "conv4.0")):
            e += _convbn_psm(f"dres{k}.{c}", f"dres{k}.{ref}")
        for c, ref in (("c5", "conv5"), ("c6", "conv6")):
            e.append((f"dres{k}.{c}.deconv.weight", (f"dres{k}.{ref}.0.weight",), "deconv"))
            e += _bn(f"dres{k}.{c}.bn", f"dres{k}.{ref}.1")
    for k in (1, 2, 3):
        e += _convbn_psm(f"classif{k}a", f"classif{k}.0") + _weight(f"classif{k}b", f"classif{k}.2")
    return e


_EMBEDDING = "hanet_last.pos_emb1d_2nd.pos_embedding.weight"


def import_densenet121(state_dict, block_config: Sequence[int] = DENSENET121_BLOCKS
                       ) -> Dict[str, torch.Tensor]:
    """A torchvision densenet121 (``features.*``, the legacy dotted names too)
    or the reference's own densenet -> {name in ``DenseNetFeatures``: tensor}."""
    return {k[len("bb."):]: v
            for k, v in _apply(_densenet("bb", block_config),
                               _torchvision_style(state_dict)).items()}


def import_xception65_backbone(state_dict, encoder) -> Dict[str, torch.Tensor]:
    """A bare Xception-65 checkpoint (unprefixed keys, as
    models_deeplab/xception.py's ``load_url`` delivers it) -> {name in the
    port's ``Xception65``: tensor}: the deeplab nets' ``-pretrained_path``."""
    return {k[len("bb."):]: v
            for k, v in _apply(xception65_entries(encoder, "bb", ""), state_dict).items()}


def import_mobilenetv3_backbone(state_dict, trunk) -> Dict[str, torch.Tensor]:
    """A MobileNetV3-Large checkpoint in cuevhv's layout (its classifier
    ignored) -> {name in ``MobileNetV3LargeFeatures``: tensor}."""
    return {k[len("bb."):]: v for k, v in _apply(_mobilenetv3("bb", "", trunk), state_dict).items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``/``.pth.tar``/``.pt`` file's state dict on the host: the
    ``state_dict`` entry of a training checkpoint if there is one, with
    DataParallel's ``module.`` prefix stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): _as_tensor(v)
            for k, v in obj.items()}


def _fillable(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    out = dict(model.named_parameters())
    out.update((n, b) for n, b in model.named_buffers() if not n.endswith("num_batches_tracked"))
    return out


@torch.no_grad()
def load_port_state(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Copy {port name: tensor} into ``model`` in place; raises ``KeyError``
    unless every parameter and BatchNorm statistic gets exactly one tensor
    and every tensor has a home, ``ValueError`` on a shape mismatch."""
    targets = _fillable(model)
    extra = sorted(set(tensors) - set(targets))
    missing = sorted(set(targets) - set(tensors))
    if extra or missing:
        raise KeyError(f"{len(missing)} port tensors got no reference tensor (e.g. {missing[:5]}), "
                       f"{len(extra)} imported tensors have no port tensor (e.g. {extra[:5]})")
    for name, dst in targets.items():
        src = tensors[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
        dst.copy_(src)
    return model


def export_state_dict(model: torch.nn.Module, entries: List[Entry]) -> Dict[str, torch.Tensor]:
    """The reference-layout state dict that ``entries`` import back to
    ``model``'s tensors (its densenet in the reference's own key style)."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = {}
    for port, refs, kind in entries:
        t = state[port]
        if kind == "copy":
            out[refs[0]] = t.clone()
        elif kind == "deconv":
            out[refs[0]] = t.transpose(0, 1).flip(_spatial(t)).contiguous()
        else:
            out.update(zip(refs, (c.clone() for c in t.chunk(len(refs), dim=0))))
    pre = "resnet_features.resnet_features."
    bb = {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}
    out = {k: v for k, v in out.items() if not k.startswith(pre)}
    out.update((pre + k, v) for k, v in _torchvision_to_ref_densenet_keys(bb).items())
    return out


def block_config_of(model: torch.nn.Module) -> Tuple[int, ...]:
    """The densenet block config of a port model's trunk."""
    bb = model.features.backbone
    return tuple(len(getattr(bb, f"denseblock{i + 1}")) for i in range(bb.n_blocks))


_EXT_VARIANTS = {"sdnet_mini_ext": "ext", "sdnet_mini_ext_v2": "v2",
                 "sdnet_mini_ext_piramid": "piramid", "sdnet_mini_ext_piramid_res": "piramid_res"}
_EXT_SMALL_VARIANTS = {"sdnet_mini_ext_small": "v0", "sdnet_mini_ext_small_edge": "edge",
                       "sdnet_mini_ext_small_edgev2": "v2"}
_LEGACY = {"sdnet_mini": minidsnet_entries, "sdnet": dsnet_entries, "sdnetv2": dsnetv2_entries,
           "sdnet_seg": seg_dsnet_entries}
_WARP_VARIANTS = {"dsnet_warp": "divide", "dsnet_warp_soft": "soft", "dsnet_warp_disp": "disp",
                  "dsnet_warp_disp_consist": "disp2"}


def _check_ported(cfg) -> None:
    m = cfg.model
    if m.net in _EXT_VARIANTS and m.multaskloss:
        raise NotImplementedError("importing the multitask modes' weights is not ported: the JAX "
                                  "package's importer does not map them either "
                                  "(ROADMAP.md queue 1, item 11.3)")
    unmapped = ""
    if m.net in _EXT_VARIANTS or m.net in _EXT_SMALL_VARIANTS or m.net in _WARP_VARIANTS:
        if m.backbone == "mobilenet":
            unmapped = "a mobilenet trunk inside a net"
        elif m.net in _EXT_SMALL_VARIANTS and (m.aspp or m.backbone in ("resnet50", "resnet101")):
            unmapped = "the Ext_small nets' ASPPs (aspp 1/2, a ResNet trunk's aspp_4)"
    if unmapped:
        raise NotImplementedError(f"importing {unmapped} is not ported: the JAX package's importer "
                                  f"does not map it either (ROADMAP.md queue 3)")


def entries_for(cfg, model: torch.nn.Module, hanet_embedding: bool = None) -> List[Entry]:
    """The importer's entries of the configured net (a ``PMTConfig``), for
    ``model`` (its trunk, HANet's encoding): what ``export_state_dict``
    inverts. ``hanet_embedding`` (HANet's learned position embedding) is the
    config's unless given."""
    _check_ported(cfg)
    m = cfg.model
    if hanet_embedding is None:
        hanet_embedding = bool(m.hanet) and not m.hanet_is_encoding
    if m.net == "sdnet_mini_ext_dlab":
        return ext_dlab_entries(model.features.trunk, m.conv_deconv_out, m.ablation or (),
                                bool(m.hanet), hanet_embedding)
    if m.net == "deeplab":
        return sppnet_mono_entries(model)
    if m.net == "deeplab_mod":
        return sppnet_stereo_entries(model)
    if m.net == "pspnet":
        return psmnet_entries()
    trunk = model.features.backbone
    if m.net in _WARP_VARIANTS:
        return minidsnet_divide_entries(trunk, _WARP_VARIANTS[m.net])
    if m.net in _EXT_VARIANTS:
        return ext_entries(trunk, m.use_att, m.conv_deconv_out, m.ablation or (), m.aspp,
                           bool(m.hanet), _EXT_VARIANTS[m.net], hanet_embedding)
    if m.net in _EXT_SMALL_VARIANTS:
        return ext_small_entries(trunk, _EXT_SMALL_VARIANTS[m.net])
    return _LEGACY[m.net](trunk)


def import_state_dict(cfg, model: torch.nn.Module, state_dict) -> Dict[str, torch.Tensor]:
    """A reference state dict of the configured net -> {port name: tensor},
    as the JAX package's importer of the same name maps it (HANet's learned
    embedding read when the dict has it)."""
    entries = entries_for(cfg, model, bool(cfg.model.hanet) and _EMBEDDING in state_dict)
    view = state_dict if cfg.model.net == "sdnet_mini_ext_dlab" else _trunk_view(state_dict)
    return _apply(entries, view)


def import_checkpoint(cfg, model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Fill ``model`` from a reference checkpoint file of the configured net."""
    return load_port_state(model, import_state_dict(cfg, model, load_torch_state_dict(path)))
