"""The port's configuration: the dataclass tree, the reference-compatible
flags and ``config_from_args``.

A copy of the JAX package's ``core/config.py`` (every field, default and
flag unchanged, so an argv line gives the same config, ``model_id()`` and
``to_json()`` in both packages). It replaces the reference's single argparse
namespace (torchConfig.py:5-58) and the dataset constants scattered through
its layers (torch_implementation.py:644-655, util/utilTorchDataLoader.py:
57-58,171-208, losses/multiLosses.py:11-21,44-57). On one card ``-gpu_n``,
``-n`` and ``-nr`` are parsed and unused, and ``-f16``/``-torch_amp`` select
the bf16 policy (``training/step.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Dataset-derived constants (reference: torch_implementation.py:644-655,
# 839-846; utilTorchDataLoader.py:57-58).
# ---------------------------------------------------------------------------

DATASET_N_LABELS = {
    "garden": 9,
    "roses": 2,
    "cityscapes": 19,
    "kitti": 19,
    "sceneflow": 19,
}

CLASS_NAMES = {
    "garden": [
        "Grass", "Ground", "Pavement", "Hedge", "Topiary", "Rose",
        "Obstacle", "Tree", "Background",
    ],
    "roses": ["Background", "Branch"],
    "cityscapes": [
        "road", "sidewalk", "building", "wall", "fence", "pole",
        "traffic light", "traffic sign", "vegetation", "terrain", "sky",
        "person", "rider", "car", "truck", "bus", "train", "motorcycle",
        "bicycle",
    ],
}
CLASS_NAMES["kitti"] = CLASS_NAMES["cityscapes"]

# ROSeS/garden depth->disparity constants (utilTorchDataLoader.py:57-58).
ROSES_FOCAL = 640.0
ROSES_BASELINE = 0.03

# Ignore class index for cityscapes/kitti (multiLosses.py:21,38).
CITYSCAPES_IGNORE = 19

VALID_NETS = (
    "sdnet", "sdnetv2", "sdnet_mini", "sdnet_mini_ext", "sdnet_mini_ext_dlab",
    "sdnet_mini_ext_v2", "sdnet_mini_ext_piramid", "sdnet_mini_ext_piramid_res",
    "sdnet_mini_ext_small", "sdnet_mini_ext_small_edge",
    "sdnet_mini_ext_small_edgev2", "sdnet_seg", "dsnet_warp", "dsnet_warp_soft",
    "dsnet_warp_disp", "dsnet_warp_disp_consist", "deeplab", "deeplab_mod",
    "pspnet",
)

VALID_BACKBONES = (
    "densenet", "dn169", "dn201", "dn161", "mobilenet", "resnet50",
    "resnet101", "efficientnet-b2", "efficientnet-b3", "efficientnet-b4",
    "efficientnet-b5",
)

VALID_LOSSES = (
    "cross_entropy", "lovasz_loss", "area_ce", "tversky_loss", "tversky_loss2",
    "ohm_loss", "binary_ce", "categoricalNlll", "area_hinge", "dice_loss",
    "diceEntropy", "dual_edge_reg", "smooth_grad", "None",
)


def output_type_for(net: str, hanet: bool = False, multaskloss: int = 0) -> str:
    """Mirror of the side-effectful dispatch in util/utilLoadNetwork.py:28-53."""
    out = "smallOutSeg" if "sdnet_mini_ext" in net else ""
    if net == "sdnet_mini":
        out = "smallOutPair"
    if net == "sdnet_seg":
        out = "smallOutWarp"
    if net in ("dsnet_warp", "dsnet_warp_soft"):
        out = "ThreeOutPuts"
    if net == "dsnet_warp_disp":
        out = "ThreeOutPutsDisp"
    if net == "dsnet_warp_disp_consist":
        out = "ThreeOutPutsDispConsist"
    if "edge" in net:
        out = "edgeOut"
    if hanet:
        out = "hanet"
    if multaskloss:
        out = "multitask"
    if "deeplab" in net:
        out = net
    if net == "pspnet":
        out = "pspnet"
    return out or "two_out"


# ---------------------------------------------------------------------------
# Config dataclasses
# ---------------------------------------------------------------------------


@dataclass
class DataConfig:
    """Dataset + input-pipeline config (reference flags -colorL et al.)."""

    dataset_name: str = "roses"
    color_l: str = ""
    color_r: str = ""
    seg: str = ""
    inst: str = ""
    disp: str = ""
    color_l_test: str = ""
    color_r_test: str = ""
    seg_test: str = ""
    inst_test: str = ""
    disp_test: str = ""
    train_compressed: str = ""  # hdf5 path (utilTorchDataLoader.py:139-144)
    test_compressed: str = ""
    crop: Tuple[int, int] = (256, 512)
    n_data: Optional[int] = None
    only_test: bool = False
    class_balance_csv: str = ""  # per-image class-occurrence CSV
    num_workers: int = 4
    prefetch: int = 2
    # eval pad/bucket shape for "crop [0,0] = full image" mode: full-image
    # eval pads to this bucket (pad_mask keeps the padding out of the metrics)
    eval_shape: Tuple[int, int] = (512, 960)

    @property
    def n_labels(self) -> int:
        return DATASET_N_LABELS[self.dataset_name]

    @property
    def ignore_index(self) -> Optional[int]:
        if self.dataset_name in ("cityscapes", "kitti"):
            return CITYSCAPES_IGNORE
        return None

    @property
    def class_names(self) -> List[str]:
        return CLASS_NAMES[self.dataset_name]


@dataclass
class ModelConfig:
    """Model-zoo config (reference flags -net/-backbone/-corrType/…)."""

    net: str = "sdnet_mini_ext"
    backbone: str = "densenet"
    corr_type: str = "1dcorr"  # '', '1dcorr', '2dcorr'
    output_activation: str = "linear"  # sigmoid | tanh | relu | linear
    edges: bool = False
    aspp: int = 0  # 0 | 1 | 2 (aspp_mod in minidsnetExt)
    use_att: bool = True
    hanet: bool = False
    multaskloss: int = 0  # 0 | 1 | 2
    # HANet position-encoding variants (models_hanet/PosEmbedding.py:49-120):
    # is_encoding=1 frozen sinusoid, 0 learned embedding; pos_noise jitters
    # the row index during training.
    hanet_is_encoding: int = 1
    hanet_pos_noise: float = 0.0
    conv_deconv_out: int = 0  # 0 | 1 | 2
    dropout: float = 0.0
    ablation: Tuple[str, ...] = ()  # 'no_dec1' | 'no_dec2' | 'no_dec3'
    pretrained: bool = False
    # path to a torch(vision) densenet121 .pth whose backbone weights are
    # imported at init (the reference's pretrained=True torch-hub load,
    # models/densenet.py:248-258, without network access)
    pretrained_path: str = ""
    max_disp_psm: int = 192  # PSMNet maxdisp (utilLoadNetwork.py:54)
    # A TPU layout choice of the JAX package (space-to-depth decoder heads);
    # the same function either way, so the port accepts and ignores it.
    s2d_heads: bool = True

    @property
    def output_type(self) -> str:
        return output_type_for(self.net, self.hanet, self.multaskloss)

    @property
    def max_disp(self) -> float:
        """Disparity normalizer (torch_implementation.py:644-655)."""
        return 1.0 if self.output_activation == "linear" else 100.0


@dataclass
class LossConfig:
    """Loss-stack config (-loss, -segWeight; multiLosses.py:8-157)."""

    losses: Tuple[str, ...] = ("cross_entropy", "lovasz_loss")
    seg_weight: bool = False


@dataclass
class OptimConfig:
    """Optimizer config (torch_implementation.py:715-724, 599-609)."""

    optim_type: str = "adam"  # adam | sgd
    # None -> reference's rule: 5e-6 deeplab, 5e-4 if >2 losses, else 1.5e-3
    learning_rate: Optional[float] = None
    adam_eps: float = 1e-7
    sgd_momentum: float = 0.9
    sgd_weight_decay: float = 1e-4
    poly_base_lr: float = 0.005
    poly_epoch_horizon: int = 2400
    accumulate_grad: int = 1  # -acmt_grad
    freeze_bn: bool = False

    def resolve_lr(self, net: str, n_losses: int) -> float:
        if self.learning_rate is not None:
            return self.learning_rate
        if self.optim_type == "sgd":
            return self.poly_base_lr
        if net == "deeplab":
            return 5e-6
        if n_losses > 2:
            return 5e-4
        return 1.5e-3


@dataclass
class ParallelConfig:
    """Parallelism and precision. The mesh fields mirror the JAX package's
    (multi-GPU is ROADMAP.md queue 1, item 10; one card uses none of them)."""

    data_axis: int = 0  # 0 -> use all visible devices on the 'data' axis
    mesh_axes: Tuple[str, ...] = ("data",)
    # mixed precision: fp32 master weights, bf16 compute (enabled by -f16 /
    # -torch_amp like the reference's apex/amp switches)
    bf16: bool = False
    sync_batchnorm: bool = True


@dataclass
class RunConfig:
    """Session-level config (train/eval/checkpoint/report)."""

    train: bool = True
    batch: int = 8
    epochs: int = 10
    save_path: str = "results"
    load_weights: str = ""
    save_img: bool = False
    show_results: bool = False
    copy_remote: bool = False
    seed: int = 0
    eval_every: int = 10  # reference evals every 10/20 epochs
    log_every: int = 5  # prints every 5 iters (torch_implementation.py:346)
    # eval-time tiled inference (the reference ships both paths but gates
    # them off by constants, torch_implementation.py:119, 265):
    # 0 = off, 1 = divideNetOutput (256x512 windows, half-stride, 0.25
    # weight), 2 = slideWindowInfer (512x512, stride 256, softmax accumulate)
    slide_window: int = 0
    # eval-time TTA for the mono deeplab net (SegmentatorTTA,
    # models_deeplab/tta.py:28-42): hflip average + optional extra scales
    tta: bool = False
    tta_scales: Tuple[float, ...] = ()


@dataclass
class PMTConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def validate(self) -> "PMTConfig":
        if self.model.net not in VALID_NETS:
            raise ValueError(f"unknown net {self.model.net!r}; valid: {VALID_NETS}")
        if self.model.backbone not in VALID_BACKBONES:
            raise ValueError(f"unknown backbone {self.model.backbone!r}")
        for l in self.loss.losses:
            if l not in VALID_LOSSES:
                raise ValueError(f"unknown loss {l!r}; valid: {VALID_LOSSES}")
        if self.data.dataset_name not in DATASET_N_LABELS:
            raise ValueError(f"unknown dataset {self.data.dataset_name!r}")
        if self.model.output_activation not in ("sigmoid", "tanh", "relu", "linear"):
            raise ValueError(f"bad activation {self.model.output_activation!r}")
        if self.model.corr_type not in ("", "1dcorr", "2dcorr", "None", None):
            raise ValueError(f"bad corrType {self.model.corr_type!r}")
        return self

    # -- identity string: mirrors the reference's checkpoint filename encoding
    # (torch_implementation.py:823-831) so runs remain distinguishable.
    def model_id(self) -> str:
        m, d, lo, o = self.model, self.data, self.loss, self.optim
        losses = "_".join(lo.losses)
        abl = "_".join(m.ablation) if m.ablation else ""
        return (
            f"model_{m.net}_i{d.crop[0]}_{d.crop[1]}_e{self.run.epochs}"
            f"_b{self.run.batch}_a{m.output_activation}_o{m.output_type}"
            f"_w{int(lo.seg_weight)}_l{losses}_cr{m.corr_type}_aspp{m.aspp}"
            f"_optim{o.optim_type}_backbone{m.backbone}_ablt{abl}"
            f"{'_hanet1' if m.hanet else ''}_att{int(m.use_att)}"
            f"_dropout{m.dropout}"
            f"{'_multaskloss' + str(m.multaskloss) if m.multaskloss else ''}"
            f"_data{d.dataset_name}"
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "PMTConfig":
        raw = json.loads(s)

        def build(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                if isinstance(v, list):
                    v = tuple(v)
                kw[f.name] = v
            return cls(**kw)

        return PMTConfig(
            data=build(DataConfig, raw.get("data", {})),
            model=build(ModelConfig, raw.get("model", {})),
            loss=build(LossConfig, raw.get("loss", {})),
            optim=build(OptimConfig, raw.get("optim", {})),
            parallel=build(ParallelConfig, raw.get("parallel", {})),
            run=build(RunConfig, raw.get("run", {})),
        )


# ---------------------------------------------------------------------------
# Reference-compatible CLI (torchConfig.py:5-58)
# ---------------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PMT config parser of the PyTorch port (flag-compatible with the torch reference)",
        prefix_chars="-",
    )
    a = p.add_argument
    a("-gpu_n", type=str, default="", help="parsed and unused; kept for CLI parity")
    a("-corrType", type=str, default="1dcorr")
    a("-datasetName", type=str, default="roses")
    a("-load_weights", type=str, default="")
    a("-optimType", type=str, default="adam")
    a("-backbone", type=str, default="densenet")
    a("-net", type=str, default="sdnet_mini_ext")
    a("-pretrained_path", type=str, default="",
      help="torch densenet121 .pth to import as the pretrained backbone")
    a("-n_data", type=int, default=None)
    a("-output_type", type=str, default=None)
    a("-train", type=int, default=1)
    a("-output_activation", type=str, default="sigmoid")
    a("-b", type=int, default=8, dest="batch")
    a("-e", type=int, default=10, dest="epoch")
    a("-page", type=int, default=600)
    a("-crop", default=[256], nargs="+", type=int)
    a("-w_savePath", type=str, default="")
    a("-trainCompressed", type=str, default="")
    a("-testCompressed", type=str, default="")
    a("-colorL", type=str, default="")
    a("-colorR", type=str, default="")
    a("-seg", type=str, default="")
    a("-inst", type=str, default="")
    a("-disp", type=str, default="")
    a("-colorL_test", type=str, default="")
    a("-colorR_test", type=str, default="")
    a("-seg_test", type=str, default="")
    a("-inst_test", type=str, default="")
    a("-disp_test", type=str, default="")
    a("-save_img", type=int, default=0)
    a("-slide_window", type=int, default=0,
      help="eval tiled inference: 1=divideNetOutput 2=slideWindowInfer")
    a("-tta", type=int, default=0, help="eval hflip TTA (mono deeplab)")
    a("-tta_scales", nargs="*", type=float, default=[])
    a("-copy_remote", type=int, default=0)
    a("-segWeight", type=int, default=0)
    a("-show_results", type=int, default=1)
    a("-loss", nargs="+", default=["cross_entropy"])
    a("-edges", type=int, default=0)
    a("-aspp", type=int, default=0)
    a("-only_test", type=int, default=0)
    a("-n", "--nodes", default=1, type=int)
    a("-nr", "--nr", default=0, type=int)
    a("-abilation", nargs="+", default=[])
    a("-freeze_bn", type=int, default=0)
    a("-f16", type=int, default=0, help="enable the bf16 compute policy")
    a("-torch_amp", type=int, default=0, help="alias of -f16")
    a("-acmt_grad", type=int, default=1)
    a("-use_att", type=int, default=1)
    a("-hanet", type=int, default=0)
    a("-multaskloss", type=int, default=0)
    a("-convDeconvOut", type=int, default=0)
    a("-dropout", type=float, default=0.0)
    return p


def config_from_args(argv: Optional[Sequence[str]] = None) -> PMTConfig:
    """Parse reference-style CLI flags into a PMTConfig."""
    ns = build_arg_parser().parse_args(argv)
    crop = list(ns.crop)
    if len(crop) == 1:
        crop = [crop[0], crop[0]]
    cfg = PMTConfig(
        data=DataConfig(
            dataset_name=ns.datasetName,
            color_l=ns.colorL, color_r=ns.colorR, seg=ns.seg, inst=ns.inst,
            disp=ns.disp, color_l_test=ns.colorL_test,
            color_r_test=ns.colorR_test, seg_test=ns.seg_test,
            inst_test=ns.inst_test, disp_test=ns.disp_test,
            train_compressed=ns.trainCompressed, test_compressed=ns.testCompressed,
            crop=(crop[0], crop[1]), n_data=ns.n_data,
            only_test=bool(ns.only_test),
        ),
        model=ModelConfig(
            net=ns.net, backbone=ns.backbone,
            corr_type=ns.corrType or "",
            output_activation=ns.output_activation,
            edges=bool(ns.edges), aspp=ns.aspp, use_att=bool(ns.use_att),
            hanet=bool(ns.hanet), multaskloss=ns.multaskloss,
            conv_deconv_out=ns.convDeconvOut, dropout=ns.dropout,
            ablation=tuple(ns.abilation),
            pretrained=bool(ns.pretrained_path),
            pretrained_path=ns.pretrained_path,
        ),
        loss=LossConfig(losses=tuple(ns.loss), seg_weight=bool(ns.segWeight)),
        optim=OptimConfig(
            optim_type=ns.optimType, accumulate_grad=ns.acmt_grad,
            freeze_bn=bool(ns.freeze_bn),
        ),
        parallel=ParallelConfig(bf16=bool(ns.f16 or ns.torch_amp)),
        run=RunConfig(
            train=bool(ns.train), batch=ns.batch, epochs=ns.epoch,
            save_path=ns.w_savePath or "results", load_weights=ns.load_weights,
            save_img=bool(ns.save_img), show_results=bool(ns.show_results),
            slide_window=ns.slide_window, tta=bool(ns.tta),
            tta_scales=tuple(ns.tta_scales),
        ),
    )
    return cfg.validate()
