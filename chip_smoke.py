#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (needs one CUDA card).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1; no result line is printed):

1. print the card's name and power limit; build every CUDA kernel of the
   port from the sources in this checkout (one nvcc per source, in parallel)
   and read each library's SASS;
2. hold each kernel (corr1d, corr2d) against its plain PyTorch version on
   the card at the main path's shape in fp32 and bf16 and at edge shapes
   (TF32 off), time both at the main shape, and count the tensor-core
   instructions (HMMA) in the SASS of its bf16 function;
   hold each backward kernel against its plain VJP the same way
   (corr1d's against ``correlation1d_vjp_plain`` at ``BACKWARD_CASES``,
   corr2d's against ``correlation2d_vjp_plain`` at ``BACKWARD2_CASES``: the
   training shape per view, the serving shape and edge shapes of its
   transposed band), count HMMA in its own bf16 function, time it warm and
   with the L2 flushed before each launch, and hold the gradients that
   ``torch.autograd.grad`` takes through ``correlation`` (forward kernel,
   then backward kernel) at the training shape;
3. hold the eval forward on the card against the same model with the same
   weights on the CPU at 1x64x128 in fp32: the flagship (1dcorr), sdnet, and
   the flagship with 2dcorr; and one fp32 train step of the flagship and one
   of sdnet (the bench loss stack, Adam) from the same weights and batch: in
   train mode, the loss and every updated BatchNorm running statistic within
   1e-3 * max|ref| (the flagship's gradients also within twice the devices'
   own fp32 noise); with ``freeze_bn`` (BatchNorm on its running statistics)
   on images scaled by 1e-2 and cuDNN off, the loss and every gradient
   tensor within 1e-3 * max|ref|; with cuDNN on (TF32 off), under each of
   ``CUDNN_SETTINGS``, the tensor farthest from the CPU's and the image
   convolutions' weights are printed, not held, each with its distance from
   a float64 weight gradient of the same inputs and the card's kernels;
4. serve the flagship: ``get_network`` + ``make_forward_fn`` (bf16 policy) at
   full width and depth (sdnet_mini_ext, densenet121, 1dcorr, 512x960,
   batches of 16 stereo pairs, random weights from a seed), check the
   outputs and the on-device metrics, and check that corr1d was launched
   once per batch and corr2d never;
5. serve sdnet the same way (densenet121, the 17x17 correlation), and check
   that corr2d was launched once per batch and corr1d never;
6. train the flagship: ``get_network`` + ``TrainState.create`` +
   ``make_train_step`` (bf16 policy, CE + Lovász + MultiTversky + OHEM, Adam)
   on batches of 8 stereo pairs of 256x512, 2 warm-up and 8 timed steps:
   finite losses, corr1d's forward and backward kernels once per step each,
   corr2d's never; ms/step, pairs/s and peak memory;
7. train sdnet the same way: corr2d's forward and backward kernels once per
   step each, corr1d's never;
8. from files, through the CLI, at full width and depth: write a roses
   fixture (16 training and 5 test pairs of 480x900) with the port's own
   ``make_roses_fixture``, then ``cli.train.main`` trains the flagship on it
   (``FILES_TRAIN``: bf16, the bench loss stack, 256x512 crops, 8 pairs a
   step, 2 epochs, then the per-row eval in the 512x960 bucket): the
   checkpoint directory is named by ``model_id()`` and holds ``meta_1.json``,
   ``best.json`` and one ``model_best_IOU..._Derr...``; corr1d's forward
   once a train step and once an eval forward, its backward once a train
   step, corr2d never. A fresh ``Session`` restores that checkpoint: weights,
   BatchNorm statistics and optimizer state bit-equal to the trained
   session's. The same command with ``-e 3 -load_weights`` prints "resuming
   at epoch 2" and trains one more epoch. The eval CLI (``-train 0``) at
   ``-b 4`` and ``-b 5`` gives summaries within 1e-3 relative (padding and
   batch invariance under bf16: each mean and std of the per-row table and
   each value of the pooled summary), and ``-slide_window 1`` runs corr1d
   once a forward over the 9 windows of each image. Prints ms a step
   with loading, the wait for the loader, eval pairs/s, the PNG decoder that
   ran and the time it takes for a 480x900 image;
9. the flagship family's options (``OPTIONS``) at full width and depth:
   phases 1-2 above also hold corr1d and its backward at aspp 2's site
   (``ASPP2_CASES``: the two views' ASPP outputs, 256 channels at /16, W 60
   serving and 32 training, both dtypes; each forward launch there also
   timed alone). The aspp-2 flagship serves 16 pairs of 512x960 (corr1d
   twice a batch: its two sites) and trains at 8x256x512 (corr1d and its
   backward twice a step); every other configuration (``_v2`` with aspp 1
   and ``no_dec1``, ``_piramid`` with the gates off, convDeconvOut 2 and
   HANet with a sinusoid encoding and row noise, ``_piramid_res`` with
   ``no_dec3``, convDeconvOut 1 and HANet's learned embedding, multaskloss
   1 and 2) runs its fp32 forward on the card against the CPU at 1x64x128
   (each output and multitask term within 1e-3 * max|ref|) and one bf16
   train step with finite loss and gradients; each of ``LOSS_STACKS``
   (between them every loss name of the eighth slice) holds its fp32 value
   on the card against the CPU within ``LOSS_RTOL`` and trains one step;
   the aspp-2 flagship's weights written in the reference's ``.pth.tar``
   layout restore through the eval CLI bit-equal (weights and bf16
   outputs), and ``-pretrained_path`` grafts a torchvision densenet121;
10. the zoo's trunks and the nets built on them at full width and depth:
   phase 2 above also holds corr1d and its backward at the trunks' sites
   (``TRUNK_SITES``: C = 480, 608, 1024, 136 at the serving and training
   shapes, 144-160 at the training shape) and corr2d's at 608 and 1024,
   both dtypes, printing the plan each bf16 launch takes and timing the
   serving-shape forwards against their byte bounds. The flagship on
   resnet101 and ``sdnet_mini_ext_dlab`` serve 16
   pairs of 512x960 (corr1d once a batch) and train at 8x256x512 (corr1d
   and its backward once a step); every other trunk under the flagship
   (``OTHER_TRUNKS``) runs its fp32 forward card vs CPU, one bf16 train
   step and one timed serving batch; the Ext_small nets, ``-edges`` on
   the flagship and ``sdnetv2`` (batches with a sobel ``edges`` target)
   and the dlab net with ``2dcorr`` run card vs CPU and one bf16 step,
   each forward launching its correlation once and each step its backward
   once too (phase 9's the same); a resnet101 flagship's ``.pth.tar`` restores
   bit-equal through the eval CLI and ``-pretrained_path`` grafts a
   MobileNetV3-Large in cuevhv's layout;
11. the rest of the CLI's nets (the warp family, DeepLabV3+ mono and
   stereo, PSMNet) at full width and depth: phase 2 above also holds corr1d
   and its backward at ``deeplab_mod``'s site (``DEEPLAB_MOD_SITE``: conv2
   of Xception-65's block-8 taps, 256 channels at output stride 8 of the
   padded input, (16, 65, 121, 256) serving and (8, 33, 65, 256) training:
   W 121 and 65 leave a last 64-column tile of 57 and of one column), both
   dtypes, printing each bf16 plan, timing the bf16 forward at the serving
   shape alone and the bf16 backward at the training shape with the L2
   flushed. ``deeplab_mod`` (corr1d once a batch/step), ``dsnet_warp`` on
   densenet121 (corr1d at 352 and the disparity warp) and ``pspnet``
   (maxdisp 192, no correlation) serve 16 pairs of 512x960 and train at
   8x256x512 with their launches held; every other configuration
   (``ZOO_RUNS``: ``deeplab``, the other warp nets, ``sdnet_seg``,
   ``dsnet_warp`` with 2dcorr and on resnet101) runs its fp32 forward card
   vs CPU at 1x64x128 and one bf16 train step with its launches held;
   ``-tta 1 -tta_scales 0.75 1.25`` on ``deeplab`` through the eval step card
   vs CPU; ``deeplab_mod`` and ``dsnet_warp`` weights written in the
   reference's ``.pth.tar`` layout restore bit-equal through the eval CLI,
   and ``-pretrained_path`` grafts an Xception-65 into ``deeplab``.

The third-to-last line of stdout is a JSON object with one record per
kernel, the second-to-last the card's name and power limit, and the last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --serve sdnet

only serves one net (phase 4 or 5, with 10 batches) and prints its time,
and ``python3 chip_smoke.py --train [sdnet]`` only trains (phase 6, or 7
with ``sdnet``, 2 warm-up and 10 timed steps): copied into the root of
another checkout, it times that checkout's code the same way, so two commits
can be compared in turns in one call; ``python3 chip_smoke.py --backward
[corr2d]`` does the same for a backward kernel (corr1d's by default: its
four timed cases of phase 2, without the HMMA count).
``python3 chip_smoke.py --kernels`` runs phases 1 and 2 only and prints the
kernels' record but no result line; ``python3 chip_smoke.py --files`` runs
phase 8 only, ``--options`` phase 9 only (``--serve flagship_aspp2`` and
``--train flagship_aspp2`` time that path alone), ``--trunks`` phase 10
only (``--serve dlab``, ``--train flagship_resnet101`` and the like),
``--zoo`` phase 11 only (``--serve pspnet``, ``--train deeplab_mod`` and the
like).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import contextlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PORT = "pmt_learning_for_semantic_segmentation_and_disparity_torch"
TPU_CORR = "pmt_learning_for_semantic_segmentation_and_disparity_tpu/ops/correlation.py"
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# dense peak operations per second by input type (H100 SXM data sheet):
# bf16 on the tensor cores, fp32 outside them
H100_PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BATCH, H, W = 16, 512, 960          # the serving shape of the JAX package's bench
CORR_SHAPE = (BATCH, H // 8, W // 8, 352)  # a_py2 / b_py2 at 512x960
SMALL = (1, 64, 128, 3)
# phase 10: the zoo's trunks and the nets built on them. The slice's two
# full-width paths (the flagship on resnet101, corr1d at C = 608; the dlab
# net, corr1d over ResNet-101's layer 3 at C = 1024), every other trunk
# under the flagship, the Ext_small nets, -edges, and the dlab net with the
# 17x17 correlation
TRUNK_PATHS = {"flagship_resnet101": ("sdnet_mini_ext", {"backbone": "resnet101"}),
               "dlab": ("sdnet_mini_ext_dlab", {})}
OTHER_TRUNKS = ("dn169", "dn201", "dn161", "resnet50", "efficientnet-b2", "efficientnet-b3",
                "efficientnet-b4", "efficientnet-b5", "mobilenet")
EDGE_RUNS = {"ext_small": ("sdnet_mini_ext_small", {}),
             "ext_small_edge": ("sdnet_mini_ext_small_edge", {}),
             "ext_small_edgev2": ("sdnet_mini_ext_small_edgev2", {}),
             "flagship_edges": ("sdnet_mini_ext", {"edges": True}),
             "sdnetv2_edges": ("sdnetv2", {"edges": True}),
             "dlab_2dcorr": ("sdnet_mini_ext_dlab", {"corr_type": "2dcorr"})}
TRUNK_RUNS = {**TRUNK_PATHS, **{f"flagship_{b}": ("sdnet_mini_ext", {"backbone": b})
                                for b in OTHER_TRUNKS}, **EDGE_RUNS}
# phase 11: the rest of the CLI's nets. The phase's three full-width paths
# (deeplab_mod: corr1d at its new site; dsnet_warp on densenet121: corr1d
# at 352 and the disparity warp; pspnet: no correlation), then every other
# configuration
ZOO_PATHS = {"deeplab_mod": ("deeplab_mod", {}), "dsnet_warp": ("dsnet_warp", {}),
             "pspnet": ("pspnet", {})}
ZOO_RUNS = {"deeplab": ("deeplab", {}), "dsnet_warp_soft": ("dsnet_warp_soft", {}),
            "dsnet_warp_disp": ("dsnet_warp_disp", {}),
            "dsnet_warp_disp_consist": ("dsnet_warp_disp_consist", {}),
            "sdnet_seg": ("sdnet_seg", {}),
            "dsnet_warp_2dcorr": ("dsnet_warp", {"corr_type": "2dcorr"}),
            "dsnet_warp_resnet101": ("dsnet_warp", {"backbone": "resnet101"})}
ZOO_SERVE_BATCHES = 3  # a warm-up and two timed batches
ZOO_TRAIN_STEPS = 4    # timed, after TRAIN_WARMUP
TTA_SCALES = (0.75, 1.25)
# net served -> (batches, each kernel's launches per batch): each path's own
# kernel once per batch, the other never
SERVE = {"sdnet_mini_ext": (4, {"corr1d": 1, "corr2d": 0}),
         "sdnet": (3, {"corr2d": 1, "corr1d": 0}),
         "flagship_aspp2": (4, {"corr1d": 2, "corr2d": 0}),  # both corr1d sites
         **{run: (4, {"corr1d": 1, "corr2d": 0}) for run in TRUNK_PATHS},
         "deeplab_mod": (ZOO_SERVE_BATCHES, {"corr1d": 1, "corr2d": 0}),
         "dsnet_warp": (ZOO_SERVE_BATCHES, {"corr1d": 1, "corr2d": 0}),
         "pspnet": (ZOO_SERVE_BATCHES, {"corr1d": 0, "corr2d": 0})}
TRUNK_SERVE_BATCHES = 2  # phase 10's other trunks: a warm-up and one timed batch
SERVE_BATCHES = 10  # batches --serve serves, the first a warm-up
# training: the JAX package's bench (bench.py:192-198)
TRAIN_BATCH, TRAIN_H, TRAIN_W = 8, 256, 512
TRAIN_LOSSES = ("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss")
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_H // 8, TRAIN_W // 8, 352)  # a_py2 of one view
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# phase 9: the flagship at -aspp 2 correlates the two views' ASPP outputs
# (256 channels at /16) with a second, unnormalized corr1d
ASPP2_SERVE_SHAPE = (BATCH, H // 16, W // 16, 256)                     # (16, 32, 60, 256)
ASPP2_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_H // 16, TRAIN_W // 16, 256)   # (8, 16, 32, 256)
ASPP2_CASES = [(ASPP2_SERVE_SHAPE, torch.float32), (ASPP2_SERVE_SHAPE, torch.bfloat16),
               (ASPP2_TRAIN_SHAPE, torch.float32), (ASPP2_TRAIN_SHAPE, torch.bfloat16)]
# the forward shapes the kernel phase times (each kernel meets its own)
TIMED_FORWARD = (CORR_SHAPE, ASPP2_SERVE_SHAPE, ASPP2_TRAIN_SHAPE)
# corr1d's backward against correlation1d_vjp_plain: the training shape per
# view (main path) and the serving shape in both dtypes, then edge shapes of
# the bf16 transposed band (64-column tiles with an 8-column halo, 64-channel
# boxes) and of the fp32 tile (64 columns x 64 channels, 4 channels a
# thread), with an element offset of the inputs' storage where one is given
BACKWARD_CASES = [
    (TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
    (CORR_SHAPE, torch.float32), (CORR_SHAPE, torch.bfloat16),
    *ASPP2_CASES,                           # aspp 2's site: W 60 and 32, C 256
    ((1, 3, 63, 64), torch.bfloat16),       # W against the 64-column tile and its halo:
    ((1, 3, 64, 64), torch.bfloat16),       # one tile short, one tile, one column over,
    ((1, 3, 65, 64), torch.bfloat16),       # the serving width, two whole tiles
    ((2, 3, 120, 64), torch.bfloat16),
    ((1, 3, 128, 64), torch.bfloat16),
    ((2, 3, 16, 64), torch.bfloat16),       # W < 17: the halo is wider than the map
    ((1, 2, 9, 20), torch.bfloat16),        # W < 17 and C % 8 != 0: element staging
    ((2, 3, 40, 24), torch.bfloat16),       # C < 64: one box, clipped by the copy engine
    ((1, 3, 70, 352), torch.bfloat16),      # C = 352: a last box of 32 channels
    ((1, 3, 70, 360), torch.bfloat16),      # C = 360: a last box of 40 channels
    ((2, 3, 33, 37), torch.bfloat16),       # C % 8 != 0: element staging and stores
    ((2, 3, 70, 352), torch.bfloat16, 1),   # inputs off 16-byte alignment: element
    ((2, 3, 70, 352), torch.bfloat16, 2),   # staging and stores
    ((1, 2, 9, 20), torch.float32),         # fp32: W < 17, C % 4 == 0 (float4 staging)
    ((2, 3, 17, 64), torch.float32),        # W = 17
    ((1, 3, 65, 64), torch.float32),        # one column past the 64-column tile
    ((1, 3, 130, 360), torch.float32),      # three tiles, a 40-channel tail
    ((2, 3, 33, 37), torch.float32),        # C % 4 != 0: element staging and stores
    ((2, 3, 65, 36), torch.float32, 1),     # inputs off 16-byte alignment
    ((2, 3, 33, 37), torch.float32, 1),
]
# corr2d's backward against correlation2d_vjp_plain: the training and
# serving shapes in both dtypes, then edge shapes: H and W against the 8-row
# and 8-column reach of the patch and the 64-column tile (1, 7, 16, 17, 18,
# 65), C against the 64-channel box (16, 24, 352, 360), element staging (C %
# 8 != 0 in bf16, C % 4 != 0 in fp32) and element offsets of the storage
BACKWARD2_CASES = [
    (TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
    (CORR_SHAPE, torch.float32), (CORR_SHAPE, torch.bfloat16),
    ((1, 1, 65, 64), torch.bfloat16),       # H = 1: one row offset
    ((1, 65, 1, 64), torch.bfloat16),       # W = 1
    ((2, 7, 7, 24), torch.bfloat16),        # H, W below the patch's reach; C < 64
    ((1, 16, 17, 16), torch.bfloat16),      # C = one mma step
    ((1, 17, 16, 64), torch.bfloat16),
    ((1, 18, 18, 360), torch.bfloat16),     # C = 360: a last box of 40 channels
    ((1, 18, 65, 352), torch.bfloat16),     # a tile and one column; a 32-channel box
    ((2, 9, 20, 37), torch.bfloat16),       # C % 8 != 0: element staging and stores
    ((1, 18, 70, 352), torch.bfloat16, 2),  # inputs off 16-byte alignment
    ((1, 1, 7, 24), torch.float32),         # fp32: H = 1, W < 8
    ((1, 7, 1, 16), torch.float32),         # W = 1
    ((2, 17, 18, 64), torch.float32),
    ((1, 18, 65, 360), torch.float32),      # one column past the tile, a 40-channel tail
    ((2, 9, 20, 37), torch.float32),        # C % 4 != 0: element staging and stores
    ((1, 16, 70, 36), torch.float32, 1),    # inputs off 16-byte alignment
    ((1, 16, 17, 352), torch.float32, 2),
]
# phase 2, the trunks' sites (phase 10's nets): corr1d correlates the
# enriched tap 2 (the trunk's tap-2 channels + 96) at /8, and the dlab net
# ResNet-101's layer 3 (1024 channels at /8); C -> the nets that bring it
TRUNK_SITES = {480: "dn161", 608: "resnet50, resnet101", 1024: "sdnet_mini_ext_dlab",
               136: "mobilenet", 144: "efficientnet-b2, -b3", 152: "efficientnet-b4",
               160: "efficientnet-b5"}
SITE_SERVE_CS = (480, 608, 1024, 136)          # held at the serving and training shapes
SITE_TRAIN_CS = SITE_SERVE_CS + (144, 152, 160)  # at the training shape only
SITE_CORR2D_CS = (608, 1024)                   # corr2d, training shape (the 2dcorr variants)
# deeplab_mod's site: conv2 of Xception-65's block-8 taps, 256 channels at
# output stride 8 of the input padded by one (513x961 -> 65x121 serving,
# 257x513 -> 33x65 per view in training)
DEEPLAB_MOD_SITE = {"serving": (BATCH, 65, 121, 256), "training": (TRAIN_BATCH, 33, 65, 256)}


def site_shape(c: int, serving: bool):
    return (BATCH, H // 8, W // 8, c) if serving else (TRAIN_BATCH, TRAIN_H // 8, TRAIN_W // 8, c)


# backward kernel -> (wrapper, plain VJP, cases, the TPU code it replaces,
# the name of its bf16 function)
BACKWARDS = {
    "corr1d": ("correlation1d_backward_cuda", "correlation1d_vjp_plain", BACKWARD_CASES,
               f"{TPU_CORR}:320", "corr1d_bwd_band_kernel"),
    "corr2d": ("correlation2d_backward_cuda", "correlation2d_vjp_plain", BACKWARD2_CASES,
               f"{TPU_CORR}:368", "corr2d_bwd_band_kernel"),
}
# phase 9's configurations of the flagship family: name -> (net, model
# options), combined where the flags allow; "flagship_aspp2" is the slice's
# full-width path
OPTIONS = {
    "flagship_aspp2": ("sdnet_mini_ext", {"aspp": 2}),
    "v2_aspp1_no_dec1": ("sdnet_mini_ext_v2", {"aspp": 1, "ablation": ("no_dec1",)}),
    "piramid_att0_cdo2_hanet1": ("sdnet_mini_ext_piramid", {
        "use_att": False, "conv_deconv_out": 2, "hanet": True, "hanet_is_encoding": 1,
        "hanet_pos_noise": 0.5}),
    "piramid_res_no_dec3_cdo1_hanet0": ("sdnet_mini_ext_piramid_res", {
        "ablation": ("no_dec3",), "conv_deconv_out": 1, "hanet": True, "hanet_is_encoding": 0}),
    "multitask1": ("sdnet_mini_ext", {"multaskloss": 1}),
    "multitask2": ("sdnet_mini_ext", {"multaskloss": 2}),
}
# run name -> (net, model options): the nets of phases 3-8 as they are, and
# phases 9's and 10's
RUNS = {"sdnet_mini_ext": ("sdnet_mini_ext", {}), "sdnet": ("sdnet", {}), **OPTIONS, **TRUNK_RUNS,
        **ZOO_PATHS, **ZOO_RUNS}
# run trained -> each kernel's launches per step: its path's forward and
# backward kernels once each (aspp 2: twice, its two corr1d sites), the
# other correlation's never
TRAIN = {"sdnet_mini_ext": {"corr1d": 1, "corr1d_backward": 1, "corr2d": 0, "corr2d_backward": 0},
         "sdnet": {"corr2d": 1, "corr2d_backward": 1, "corr1d": 0, "corr1d_backward": 0},
         "flagship_aspp2": {"corr1d": 2, "corr1d_backward": 2, "corr2d": 0, "corr2d_backward": 0},
         **{run: {"corr1d": 1, "corr1d_backward": 1, "corr2d": 0, "corr2d_backward": 0}
            for run in (*TRUNK_PATHS, "deeplab_mod", "dsnet_warp")},
         "pspnet": {"corr1d": 0, "corr1d_backward": 0, "corr2d": 0, "corr2d_backward": 0}}
# phase 9's loss stacks with their datasets: between them every loss name
# ported in the eighth slice (each stack is head 2's and the disparity
# head's, as -loss sets them); dual_edge_reg reads the trailing ignore
# channel of cityscapes' ground truth (19 classes + 1)
LOSS_STACKS = ((("cross_entropy", "area_ce", "tversky_loss2", "dice_loss", "smooth_grad"), "roses"),
               (("binary_ce", "categoricalNlll", "area_hinge", "lovasz_loss"), "roses"),
               (("dual_edge_reg", "ohm_loss", "cross_entropy", "diceEntropy"), "cityscapes"))
LOSS_SHAPE = (2, 64, 128)  # card vs CPU loss values, within LOSS_RTOL
LOSS_RTOL = 1e-4
# the cuDNN settings phase 3 reads (prints) on the freeze_bn step, TF32 off
CUDNN_SETTINGS = {"default": {}, "deterministic": {"deterministic": True},
                  "benchmark": {"benchmark": True}}
# bytes written between two launches to flush the card's 50 MB L2 (the
# "cold" backward times)
FLUSH_BYTES = 256 * 2**20

# kernel -> (wrapper in ops/correlation.py, the TPU kernel it replaces, edge
# shapes with their dtypes, and an element offset of both inputs' storage
# where it is not 0); its patch is ops/correlation.py's KERNEL_PATCH. fp32
# runs corr_tile.cuh's row tile, bf16 corr_band.cuh's tensor-core band tile
# (64-column tiles, 64-channel boxes of 16-channel mma steps; corr2d two rows
# a block).
KERNELS = {
    "corr1d": ("correlation1d_cuda", f"{TPU_CORR}:159", [
        *ASPP2_CASES,                        # aspp 2's site: W 60 and 32, C 256
        ((1, 3, 9, 20), torch.float32),      # W < 17, B = 1
        ((2, 5, 70, 37), torch.bfloat16),    # W not a multiple of the 64-column tile,
        ((2, 5, 70, 37), torch.float32),     # C not a multiple of the 32-channel chunk
        ((1, 4, 130, 352), torch.float32),   # three tiles, the last of 2 columns
        ((1, 2, 16, 8), torch.bfloat16),     # C below one chunk
        ((1, 3, 16, 64), torch.bfloat16),    # W = 16, 17, 64, 65, 120 against the
        ((1, 3, 17, 64), torch.bfloat16),    # 64-column tile and its halo
        ((1, 3, 64, 64), torch.bfloat16),
        ((1, 3, 65, 64), torch.bfloat16),
        ((1, 3, 120, 64), torch.bfloat16),
        ((2, 3, 40, 16), torch.bfloat16),    # C = one mma step
        ((2, 3, 40, 24), torch.bfloat16),    # C = a step and a half
        ((1, 3, 70, 360), torch.bfloat16),   # C = 360: a last box of 40 channels
        ((2, 3, 70, 352), torch.bfloat16, 2),  # misaligned inputs: element staging
    ]),
    "corr2d": ("correlation2d_cuda", f"{TPU_CORR}:221", [
        ((1, 5, 9, 20), torch.float32),      # H, W < 17, B = 1 (vector loads)
        ((1, 5, 9, 20), torch.bfloat16),     # the same, scalar loads (20 % 8 != 0)
        ((2, 1, 70, 37), torch.float32),     # H = 1, W not a multiple of the tile,
        ((2, 1, 70, 37), torch.bfloat16),    # C not a multiple of the chunk
        ((2, 5, 70, 37), torch.bfloat16),
        ((1, 20, 130, 352), torch.float32),  # three tiles, rows in and out of reach
        ((1, 3, 16, 8), torch.bfloat16),     # C below one chunk
        ((1, 5, 16, 64), torch.bfloat16),    # W = 16, 17, 64, 65, 120 against the
        ((1, 5, 17, 64), torch.bfloat16),    # 64-column tile and its halo
        ((1, 5, 64, 64), torch.bfloat16),
        ((1, 5, 65, 64), torch.bfloat16),
        ((1, 5, 120, 64), torch.bfloat16),
        ((1, 17, 40, 32), torch.bfloat16),   # H = 17, 18 against the pair of rows
        ((1, 18, 40, 32), torch.bfloat16),   # a block owns and the 17 shifts
        ((2, 6, 40, 16), torch.bfloat16),    # C = one mma step
        ((2, 6, 40, 24), torch.bfloat16),    # C = a step and a half
        ((1, 20, 70, 360), torch.bfloat16),  # C = 360: a last box of 40 channels
        ((1, 6, 40, 1000), torch.bfloat16),  # f1 too large to stay resident
        ((1, 18, 70, 352), torch.bfloat16, 2),  # misaligned inputs: element staging
    ]),
}


# phase 8: the CLI on files (16 training and 5 test pairs of 480x900: the
# eval pads them into the 512x960 bucket)
FILES_HW, FILES_TRAIN_PAIRS, FILES_TEST_PAIRS = (480, 900), 16, 5
FILES_TRAIN = ("-net sdnet_mini_ext -backbone densenet -corrType 1dcorr -crop 256 512 -b 8 -e 2 "
               "-loss cross_entropy lovasz_loss tversky_loss ohm_loss -output_activation linear "
               "-datasetName roses -f16 1 -train 1 -show_results 0").split()
FILES_EVAL_BATCHES = (4, 5)  # eval CLI batch sizes, held within FILES_EVAL_RTOL of each other
FILES_EVAL_RTOL = 1e-3
FILES_WINDOWS = 9  # -slide_window 1: 256x512 windows at half stride over the 512x960 bucket


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def correlation_module():
    # by path: the package ``ops`` re-exports the function ``correlation``
    # over its module's name
    return importlib.import_module(f"{PORT}.ops.correlation")


def wrapper(name: str):
    return getattr(correlation_module(), KERNELS[name][0])


def counters() -> dict:
    """The four wrappers whose ``launches`` count a train step's launches."""
    correlation = correlation_module()
    return {"corr1d": correlation.correlation1d_cuda,
            "corr1d_backward": correlation.correlation1d_backward_cuda,
            "corr2d": correlation.correlation2d_cuda,
            "corr2d_backward": correlation.correlation2d_backward_cuda}


def one_correlation(run: str, step: bool = False) -> dict:
    """The launches of one card forward (``step``: one train step) of a run
    of phases 9-11 other than the aspp-2 flagship: its correlation's kernel
    once, and in a step its backward once; the other correlation's kernels
    never. Multitask mode 2 takes both heads from a4 alone and correlates
    nothing, nor do ``deeplab`` and ``pspnet``; ``deeplab_mod`` correlates
    with corr1d whatever ``-corrType`` says."""
    m = run_config(run).model
    corr = "corr2d" if m.corr_type == "2dcorr" and m.net != "deeplab_mod" else "corr1d"
    other = "corr1d" if corr == "corr2d" else "corr2d"
    n = 0 if m.multaskloss == 2 or m.net in ("deeplab", "pspnet") else 1
    out = {corr: n, other: 0}
    if step:
        out.update({f"{corr}_backward": n, f"{other}_backward": 0})
    return out


def phase_build():
    """Build every kernel library; returns {library: its SASS}."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()), flush=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(_kernels._nvcc()).parent / "cuobjdump")
    return {name: subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                                 check=True, timeout=120).stdout
            for name, path in paths.items()}


def hmma_count(sass: dict, library: str, function: str) -> int:
    """Tensor-core instructions (HMMA/HGMMA) in the machine code of the
    library's functions whose (mangled) name holds ``function``; fails if
    there are none. The bf16 band tiles' mma.sync compiles to HMMA."""
    counts, current = {}, None
    for line in sass[library].splitlines():
        if line.strip().startswith("Function :"):
            current = line.split(":", 1)[1].strip()
            if function in current:
                counts[current] = 0
        elif current in counts and ("HMMA" in line or "HGMMA" in line):
            counts[current] += 1
    total = sum(counts.values())
    print(f"[sass] {library} {function}: {total} HMMA/HGMMA instructions in "
          f"{len(counts)} function(s) ({', '.join(f'{v}' for v in counts.values())})", flush=True)
    check(all(counts.values()) and counts,
          f"{library}: no tensor-core instruction in a function named *{function}*")
    return total


def inputs(shape, dtype, g, offset: int = 0):
    """A contiguous random tensor whose storage starts ``offset`` elements
    into its allocation (offset 2 of a bf16 tensor: 4 bytes off 16-byte
    alignment)."""
    n = torch.Size(shape).numel()
    return torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:].view(shape)


def phase_kernel(name: str, sass: dict):
    """One kernel against correlation_plain; returns its JSON record
    (without the main path's launch count)."""
    correlation = correlation_module()
    correlation_plain = correlation.correlation_plain
    _, replaces, edges = KERNELS[name]
    patch = correlation.KERNEL_PATCH[name]
    fn = wrapper(name)
    arg = patch[1] if name == "corr1d" else patch
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(CORR_SHAPE, torch.float32), (CORR_SHAPE, torch.bfloat16)] + edges
    # fp32: summation order only; bf16: the output's bf16 rounding (the plain
    # version also rounds each product to bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    record = {}
    for shape, dtype, *offset in cases:
        f1, f2 = (inputs(shape, dtype, g, *offset) for _ in range(2))
        out = fn(f1, f2, arg)
        torch.cuda.synchronize()
        ref = correlation_plain(f1, f2, patch)
        check(out.shape == ref.shape and out.dtype == dtype, f"{name} {shape} shape/dtype")
        err = (out.float() - ref.float()).abs().max().item()
        bound = tol[dtype] * ref.float().abs().max().item()
        where = f" at element offset {offset[0]}" if offset else ""
        print(f"[{name}] {tuple(shape)} {str(dtype)[6:]}{where}: max|d| = {err:.6g} "
              f"(tolerance {bound:.6g} = {tol[dtype]:g} * max|ref|)", flush=True)
        check(err <= bound, f"{name} {shape} {dtype}{where}: max|d| {err} > {bound}")
        if shape not in TIMED_FORWARD or offset:
            continue
        ms = cuda_time_ms(lambda: fn(f1, f2, arg), iters=50)
        plain_ms = cuda_time_ms(lambda: correlation_plain(f1, f2, patch), iters=3, warmup=1)
        nbytes = (f1.numel() + f2.numel() + out.numel()) * f1.element_size()
        ops = 2 * out.numel() * shape[-1]
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_PEAK_OPS[dtype] * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"[{name}] {tuple(shape)} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
        if shape != CORR_SHAPE:  # aspp 2's site
            # back to back, a launch at this size may take the wrapper's host
            # time; each launch timed by its own events behind a card-side spin
            warm_ms, _ = event_time_ms(lambda: fn(f1, f2, arg), 50, flush=False)
            print(f"[{name}] {tuple(shape)} {str(dtype)[6:]}: {warm_ms:.4f} ms a launch timed alone "
                  f"(warm), {bound_ms / warm_ms:.1%} of the bound", flush=True)
            record.setdefault("other_shapes", []).append(
                {"shape": list(shape), "dtype": str(dtype)[6:], "ms": ms, "ms_warm": warm_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": err,
                 "share_of_bound": bound_ms / ms})
        elif dtype == torch.bfloat16:  # the serving path's dtype
            record = {**record, "name": name, "route": "cuda", "source": f"{PORT}/csrc/{name}.cu",
                      "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": None, "share_of_bound": bound_ms / ms,
                      "sass_hmma": hmma_count(sass, name, f"{name}_band_kernel")}
        del out, ref
    return record


def event_time_ms(fn, iters: int, flush: bool, warmup: int = 3):
    """(mean, median) ms of ``fn``, each launch timed by its own pair of
    events behind a ~0.2 ms spin of the card, so that the launch waits on the
    card and not on the host's call; with ``flush``, the L2 is flushed
    before each launch (FLUSH_BYTES written)."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda") if flush else None
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        if flush:
            buf.zero_()
        torch.cuda._sleep(400_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return sum(times) / iters, times[iters // 2]


def phase_backward(name: str, sass, cases=None, autograd: bool = True):
    """The backward kernel of ``name`` (corr1d, corr2d) against its plain VJP
    at ``cases`` (its ``BACKWARDS`` cases by default); returns its JSON record
    (without the main path's launch count): the bf16 function's HMMA count
    (``sass`` None: not counted), and its times at the training shape per
    view in bf16 with the L2 flushed before each launch (``ms``, the time
    compared with the byte bound), warm (``ms_warm``, each launch timed by its
    own events) and back to back (``ms_back_to_back``, which at this shape
    measures the wrapper's host time)."""
    correlation = correlation_module()
    wrapper_name, plain_name, default_cases, replaces, band_fn = BACKWARDS[name]
    kernel = getattr(correlation, wrapper_name)
    patch = correlation.KERNEL_PATCH[name]
    arg = patch[1] if name == "corr1d" else patch

    def plain(f1, f2, grad):
        return getattr(correlation, plain_name)(f1, f2, grad, arg)

    hmma = hmma_count(sass, name, band_fn) if sass else None
    g = torch.Generator(device="cuda").manual_seed(3)
    # fp32: summation order only; bf16: the outputs' bf16 rounding (the plain
    # version also rounds each product to bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

    def hold(got, ref, what: str, shape, dtype):
        errs = []
        for k, a, b in (("df1", got[0], ref[0]), ("df2", got[1], ref[1])):
            check(a.shape == b.shape == shape and a.dtype == dtype, f"{what} {k} shape/dtype")
            err = (a.float() - b.float()).abs().max().item()
            bound = tol[dtype] * b.float().abs().max().item()
            print(f"{what} {k}: max|d| = {err:.6g} (tolerance {bound:.6g} = {tol[dtype]:g} * max|ref|)",
                  flush=True)
            check(err <= bound, f"{what} {k}: max|d| {err} > {bound}")
            errs.append(err)
        return errs

    record = {}
    for shape, dtype, *offset in default_cases if cases is None else cases:
        f1, f2 = (inputs(shape, dtype, g, *offset) for _ in range(2))
        grad = inputs(tuple(shape[:3]) + (patch[0] * patch[1],), dtype, g, *offset)
        got = kernel(f1, f2, grad)
        torch.cuda.synchronize()
        where = f" at element offset {offset[0]}" if offset else ""
        errs = hold(got, plain(f1, f2, grad), f"[{name} backward] {tuple(shape)} {str(dtype)[6:]}{where}",
                    f1.shape, dtype)
        if offset or shape not in (TRAIN_SHAPE, CORR_SHAPE, ASPP2_SERVE_SHAPE, ASPP2_TRAIN_SHAPE):
            continue
        # back to back (as the forward kernels are timed): the card's time
        # per launch, or the wrapper's host time where that is longer
        b2b_ms = cuda_time_ms(lambda: kernel(f1, f2, grad), iters=50)
        t0 = time.perf_counter()
        for _ in range(50):
            kernel(f1, f2, grad)
        host_ms = 1e3 * (time.perf_counter() - t0) / 50
        torch.cuda.synchronize()
        warm_ms, warm_median = event_time_ms(lambda: kernel(f1, f2, grad), 50, flush=False)
        ms, median_ms = event_time_ms(lambda: kernel(f1, f2, grad), 50, flush=True)
        plain_ms = cuda_time_ms(lambda: plain(f1, f2, grad), iters=3, warmup=1)
        # read f1, f2 and g once, write df1 and df2 once; the useful products
        # at the dtype's peak
        nbytes = (4 * f1.numel() + grad.numel()) * f1.element_size()
        ops = 2 * 2 * grad.numel() * shape[-1]
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_PEAK_OPS[dtype] * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"[{name} backward] {tuple(shape)} {str(dtype)[6:]}: kernel {ms:.4f} ms with the L2 "
              f"flushed (median {median_ms:.4f}), {warm_ms:.4f} ms warm (median {warm_median:.4f}), "
              f"{b2b_ms:.4f} ms a launch back to back (host {host_ms:.4f} ms a call), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP, by {'bytes' if t_bytes >= t_ops else 'operations'}), "
              f"{bound_ms / ms:.1%} of the bound flushed, {bound_ms / warm_ms:.1%} warm", flush=True)
        if shape in (ASPP2_SERVE_SHAPE, ASPP2_TRAIN_SHAPE):  # aspp 2's site
            record.setdefault("other_shapes", []).append(
                {"shape": list(shape), "dtype": str(dtype)[6:], "ms": ms, "ms_warm": warm_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": max(errs),
                 "share_of_bound": bound_ms / ms})
        elif shape == TRAIN_SHAPE and dtype == torch.bfloat16:  # the training path's
            record = {**record, "name": f"{name}_backward", "route": "cuda",
                      "source": f"{PORT}/csrc/{name}.cu",
                      "replaces": replaces, "max_abs_err": max(errs), "ms": ms,
                      "ms_warm": warm_ms, "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": None, "share_of_bound": bound_ms / ms, "sass_hmma": hmma}
        del got
    # the autograd wiring the train step runs: the gradients of the
    # dispatcher the models call (the forward kernel, then the backward
    # kernel from the autograd Function's backward) against the plain VJP;
    # corr2d as the nets call it, normalized by C outside the kernels
    normalize = name == "corr2d"
    for dtype in (torch.float32, torch.bfloat16) if autograd else ():
        f1, f2 = (inputs(TRAIN_SHAPE, dtype, g).requires_grad_() for _ in range(2))
        grad = inputs(TRAIN_SHAPE[:3] + (patch[0] * patch[1],), dtype, g)
        before = kernel.launches
        got = torch.autograd.grad(correlation.correlation(f1, f2, patch, normalize=normalize),
                                  (f1, f2), grad)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"autograd through correlation: {name}'s backward "
              f"kernel was launched {kernel.launches - before} times, expected once")
        scaled = grad / TRAIN_SHAPE[-1] if normalize else grad
        hold(got, plain(f1.detach(), f2.detach(), scaled),
             f"[{name} autograd{' normalized' if normalize else ''}] {TRAIN_SHAPE} {str(dtype)[6:]}",
             f1.shape, dtype)
    return record


def byte_bound_ms(nbytes: float, ops: float, dtype):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak for the dtype."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def plan_text(plan: dict) -> str:
    return (f"{plan['stages']} stages x {plan['boxes_per_stage']} boxes, f1 "
            f"{'resident' if plan['f1_resident'] else 'staged'}, {plan['smem_bytes']} B")


def site_cases(name: str):
    """(shape, dtype, the nets that bring it) of ``name``'s cases at the
    trunks' sites and (corr1d) at deeplab_mod's."""
    if name == "corr2d":
        shapes = [(site_shape(c, False), TRUNK_SITES[c]) for c in SITE_CORR2D_CS]
    else:
        shapes = ([(site_shape(c, True), TRUNK_SITES[c]) for c in SITE_SERVE_CS]
                  + [(site_shape(c, False), TRUNK_SITES[c]) for c in SITE_TRAIN_CS]
                  + [(shape, "deeplab_mod") for shape in DEEPLAB_MOD_SITE.values()])
    return [(shape, dtype, site) for shape, site in shapes for dtype in (torch.float32, torch.bfloat16)]


def phase_sites(name: str) -> list:
    """Phase 2 at the trunks' sites (``TRUNK_SITES``) and deeplab_mod's
    (``DEEPLAB_MOD_SITE``): the forward kernel ``name`` and its backward
    against their plain versions in fp32 and bf16 (corr1d at the serving and
    training shapes, corr2d at the training shape); each bf16 forward's plan
    (``forward_plan``) printed; the bf16 forward at corr1d's serving shapes
    and corr2d's training shapes timed, a launch alone (warm) and back to
    back, against its byte bound; each bf16 backward timed alone with the L2
    flushed. Returns one record a case."""
    correlation = correlation_module()
    patch = correlation.KERNEL_PATCH[name]
    arg = patch[1] if name == "corr1d" else patch
    fn = wrapper(name)
    bwd_name, plain_bwd, *_ = BACKWARDS[name]
    bwd = getattr(correlation, bwd_name)
    g = torch.Generator(device="cuda").manual_seed(13)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    records = []
    for shape, dtype, site in site_cases(name):
        tag = f"[{name} site {site}] {tuple(shape)} {str(dtype)[6:]}"
        f1, f2 = (inputs(shape, dtype, g) for _ in range(2))
        out = fn(f1, f2, arg)
        ref = correlation.correlation_plain(f1, f2, patch)
        check(out.shape == ref.shape and out.dtype == dtype, f"{tag} shape/dtype")
        err = (out.float() - ref.float()).abs().max().item()
        bound = tol[dtype] * ref.float().abs().max().item()
        print(f"{tag}: forward max|d| = {err:.6g} (tolerance {bound:.6g})", flush=True)
        check(err <= bound, f"{tag}: forward max|d| {err} > {bound}")
        rec = {"shape": list(shape), "dtype": str(dtype)[6:], "site": site, "max_abs_err": err}
        del out, ref
        grad = inputs(tuple(shape[:3]) + (patch[0] * patch[1],), dtype, g)
        got = bwd(f1, f2, grad)
        want = getattr(correlation, plain_bwd)(f1, f2, grad, arg)
        errs = []
        for k, a, b in (("df1", got[0], want[0]), ("df2", got[1], want[1])):
            check(a.shape == b.shape == f1.shape and a.dtype == dtype, f"{tag} backward {k}")
            e = (a.float() - b.float()).abs().max().item()
            bd = tol[dtype] * b.float().abs().max().item()
            check(e <= bd, f"{tag}: backward {k} max|d| {e} > {bd}")
            errs.append(e / bd if bd else 0.0)
        print(f"{tag}: backward df1, df2 within tolerance ({max(errs):.3g} of it at most)", flush=True)
        rec["backward_err_share_of_tolerance"] = max(errs)
        del got, want
        if dtype == torch.bfloat16:
            rec["plan"] = correlation.forward_plan(name, shape[-1])
            nbytes = (f1.numel() + f2.numel() + f1.numel() // shape[-1] * patch[0] * patch[1]) * 2
            ops = 2 * f1.numel() * patch[0] * patch[1]
            rec["bound_ms"], rec["bound_by"] = byte_bound_ms(nbytes, ops, dtype)
            line = f"{tag}: plan {plan_text(rec['plan'])}; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            if name == "corr2d" or shape[0] == BATCH:
                launch = lambda: fn(f1, f2, arg)
                rec["ms"], _ = event_time_ms(launch, 30, flush=False)
                rec["ms_back_to_back"] = cuda_time_ms(launch, iters=30)
                line += (f"; {rec['ms']:.4f} ms a launch alone ({rec['bound_ms'] / rec['ms']:.1%} "
                         f"of the bound), {rec['ms_back_to_back']:.4f} back to back")
            # the backward: read f1, f2, g once, write df1, df2 once
            bbytes = (4 * f1.numel() + grad.numel()) * 2
            rec["backward_bound_ms"], _ = byte_bound_ms(bbytes, 2 * ops, dtype)
            rec["backward_ms_flushed"], _ = event_time_ms(lambda: bwd(f1, f2, grad), 20, flush=True)
            line += (f"; backward {rec['backward_ms_flushed']:.4f} ms flushed (bound "
                     f"{rec['backward_bound_ms']:.4f}, {rec['backward_bound_ms'] / rec['backward_ms_flushed']:.1%})")
            print(line, flush=True)
        records.append(rec)
        del f1, f2, grad
    return records


def config(net: str, corr_type: str = "1dcorr", bf16: bool = False, options: dict = None):
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig

    cfg = PMTConfig()
    cfg.model.net = net
    cfg.model.corr_type = corr_type
    cfg.parallel.bf16 = bf16
    for k, v in (options or {}).items():
        setattr(cfg.model, k, v)
    return cfg


def run_config(run: str, bf16: bool = False):
    """The config of a run of ``RUNS`` (a net and its model options)."""
    net, options = RUNS[run]
    return config(net, bf16=bf16, options=options)


def trunk_name(cfg) -> str:
    """The trunk a config's net runs on, for the printed lines."""
    if cfg.model.net == "sdnet_mini_ext_dlab":
        return "resnet101 (3x3x3 stem, output stride 8)"
    if cfg.model.net in ("deeplab", "deeplab_mod"):
        return "xception65 (output stride 8)"
    if cfg.model.net == "pspnet":
        return f"PSMNet's feature net, maxdisp {cfg.model.max_disp_psm}"
    if cfg.model.net == "sdnet_seg":
        return "densenet121"
    return {"densenet": "densenet121"}.get(cfg.model.backbone, cfg.model.backbone)


def needs_edges(cfg) -> bool:
    """Whether the net reads the batch's sobel ``edges`` (-edges, the edge
    nets' loss)."""
    return bool(cfg.model.edges) or cfg.model.output_type == "edgeOut"


def phase_small_forward(net: str, corr_type: str):
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models

    cfg = config(net, corr_type)
    g = torch.Generator().manual_seed(1)
    left, right = torch.randn(SMALL, generator=g), torch.randn(SMALL, generator=g)
    with torch.inference_mode():
        ref = models.get_network(cfg, device="cpu", seed=0)(left, right)
        got = models.get_network(cfg, device="cuda", seed=0)(left.cuda(), right.cuda())
    for k in ("seg1", "seg2", "disp1", "disp2"):
        err = (got[k].cpu() - ref[k]).abs().max().item()
        bound = 1e-3 * ref[k].abs().max().item()
        print(f"[forward {net} {corr_type} 1x64x128 fp32] {k}: card vs CPU max|d| = {err:.6g} "
              f"(tolerance {bound:.6g} = 1e-3 * max|ref|)", flush=True)
        check(err <= bound, f"small forward {net} {corr_type} {k}: {err} > {bound}")


def sobel_target(shape, g, device):
    """(B, H, W, 1) binary edge maps as the loader makes them: the port's
    ``sobel_edges`` of an instance map, here blocks of 16x16 pixels with
    random ids."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops.edges import sobel_edges

    b, h, w = shape
    ids = torch.randint(0, 6, (b, -(-h // 16), -(-w // 16)), generator=g, device=g.device).cpu()
    inst = ids.repeat_interleave(16, 1).repeat_interleave(16, 2)[:, :h, :w].numpy()
    edges = np.stack([sobel_edges(m) for m in inst])[..., None]
    return torch.from_numpy(edges).to(device)


def train_batch(shape, g, device, dataset: str = "roses", edges: bool = False):
    """A random batch (images, one-hot labels, disparity; with ``edges``, a
    sobel edge map, ``sobel_target``) of ``shape`` (B, H, W) from the
    generator ``g``: roses' 2 classes, or cityscapes' 19 and its ignore
    channel (a fifth of the pixels)."""
    n = 2 if dataset == "roses" else 19
    labels = torch.randint(0, n, shape, device=device, generator=g)
    if dataset != "roses":
        ignore = torch.rand(shape, device=device, generator=g) < 0.2
        labels = torch.where(ignore, torch.full_like(labels, n), labels)
        n += 1
    batch = {"left": torch.randn(shape + (3,), device=device, generator=g),
             "right": torch.randn(shape + (3,), device=device, generator=g),
             "seg": torch.nn.functional.one_hot(labels, n).float(),
             "disp": torch.rand(shape + (1,), device=device, generator=g)}
    if edges:
        batch["edges"] = sobel_target(shape, g, device)
    return batch


def train_setup(run: str, device: str, bf16: bool, freeze_bn: bool = False,
                losses=TRAIN_LOSSES, dataset: str = "roses"):
    """The net of the run (``RUNS``), its Adam train state and its train step
    on ``device`` (the same weights from seed 0 on every device)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
        TrainState,
        build_optimizer,
        make_train_step,
    )

    cfg = run_config(run, bf16=bf16)
    cfg.loss.losses = tuple(losses)
    cfg.data.dataset_name = dataset
    cfg.optim.freeze_bn = freeze_bn
    model = models.get_network(cfg, device=device, seed=0)
    state = TrainState.create(model, build_optimizer(cfg.optim, cfg.model.net, len(losses)))
    return model, state, make_train_step(cfg, model, device=device)


def rel_l2(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over all tensors of two {name: tensor} dicts."""
    num = sum(float(((got[n].double() - r.double()) ** 2).sum()) for n, r in ref.items())
    return (num / sum(float((r.double() ** 2).sum()) for r in ref.values())) ** 0.5


def grads_at_perturbed_weights(device: str, batch: dict) -> dict:
    """The flagship's fp32 train-mode gradient on ``device`` at the seed-0
    weights perturbed by a relative 1e-7 (the same perturbation on every
    device): how far fp32 rounding alone moves the gradient."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_loss_fn

    cfg = config("sdnet_mini_ext")
    cfg.loss.losses = TRAIN_LOSSES
    model = models.get_network(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
    loss, _ = make_loss_fn(cfg, model, device=device)(batch, True)
    loss.backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}


def small_step(net: str, device: str, batch: dict, freeze_bn: bool = False, convs: dict = None):
    """One fp32 train step of ``net`` on ``device`` from the seed-0 weights:
    the loss, {name: gradient} and {name: BatchNorm running statistic}, on
    the CPU. ``convs``, a dict, receives {conv name: [(input, output
    gradient) of each call]} of every plain convolution."""
    model, state, step = train_setup(net, device, bf16=False, freeze_bn=freeze_bn)
    hooks = []
    if convs is not None:
        def record(name):
            def hook(module, args, out):
                x = args[0].detach()
                out.register_hook(lambda gy: convs.setdefault(name, []).append((x, gy.detach())))
            return hook

        hooks = [m.register_forward_hook(record(n)) for n, m in model.named_modules()
                 if type(m) is torch.nn.Conv2d]
    _, metrics = step(state, batch)
    for h in hooks:
        h.remove()
    if convs is not None:
        convs["_model"] = model
    return (metrics["loss"].item(),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))})


def hold_loss(tag: str, loss: float, ref: float) -> None:
    err = abs(loss - ref)
    print(f"{tag} loss card {loss:.8g} CPU {ref:.8g}: |d| = {err:.6g} "
          f"(tolerance {1e-3 * abs(ref):.6g} = 1e-3 * |ref|)", flush=True)
    check(err <= 1e-3 * abs(ref), f"{tag}: loss {loss} against {ref}")


def worst_tensor(got: dict, ref: dict):
    """(max|d| / max|ref|, name) of the tensor of ``got`` farthest from
    ``ref``'s, relative to its own largest reference value."""
    return max(((got[n] - r).abs().max().item() / (r.abs().max().item() or float("inf")), n)
               for n, r in ref.items())


def hold_tensors(tag: str, what: str, got: dict, ref: dict) -> None:
    """Every tensor of ``got`` within 1e-3 * max|ref| of ``ref``'s."""
    check(set(got) == set(ref), f"{tag}: {what} of other names")
    for n, r in ref.items():
        err, bound = (got[n] - r).abs().max().item(), 1e-3 * r.abs().max().item()
        check(err <= bound, f"{tag}: {what} {n}: max|d| {err} > {bound}")
    rel, name = worst_tensor(got, ref)
    print(f"{tag} every {what} tensor ({len(ref)}) within 1e-3 * max|ref| of the CPU's; the "
          f"closest to its bound: {name} at {rel / 1e-3:.3g} of it", flush=True)


def wgrad_probe(conv: torch.nn.Conv2d, calls: list):
    """The weight gradient of ``conv`` from its recorded (input, output
    gradient) calls, recomputed on the card under the current cuDNN flags:
    (the names of the card's kernels, max|d| / max|ref| against the same
    sum in float64 on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def wgrad(x, gy):
        return torch.nn.grad.conv2d_weight(x, conv.weight.shape, gy, conv.stride, conv.padding,
                                           conv.dilation, conv.groups)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dw = sum(wgrad(x, gy) for x, gy in calls)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("void at::native")})  # cuDNN's, not the sums
    ref = sum(wgrad(x.cpu().double(), gy.cpu().double()) for x, gy in calls)
    return names, ((dw.cpu().double() - ref).abs().max() / ref.abs().max()).item()


def phase_small_train(net: str):
    """One fp32 train step of ``net`` on the card against the CPU from the
    same weights and batch (TF32 off).

    In train mode: the loss and every updated BatchNorm running statistic
    within 1e-3 * max|ref|, and for the flagship the gradients within twice
    the two devices' own fp32 noise. Train-mode BatchNorm makes the
    flagship's fp32 gradient ill-conditioned: a 1e-7 relative change of the
    weights moves it by percents, so no per-tensor bound of 1e-3 can hold
    there.

    With ``freeze_bn`` (BatchNorm on its running statistics, its gradients
    zeroed) the gradient is well-conditioned once no softmax or attention
    gate saturates, so the images are scaled by 1e-2 (at random init and
    scale 1 the eval-mode outputs reach ~1e4, and a saturated gate's
    gradient is rounding noise): the loss and every gradient tensor within
    1e-3 * max|ref|, with cuDNN off. With cuDNN on the check cannot hold for
    the flagship: the first convolution's weight gradient, a sum over every
    pixel that mostly cancels, reads 1.33e-3 * max|ref| under every one of
    ``CUDNN_SETTINGS``, though cuDNN's weight gradient from the same inputs
    agrees with float64 to ~1e-6 (PERF.md §7). So each setting is read and
    printed: the gradient tensor farthest from the CPU's and the image
    convolutions' weights, each with the kernels of its weight gradient on
    the card and its distance from a float64 sum of the same inputs. The
    float64 CPU tests hold the train-mode gradients against the JAX package
    per tensor."""
    tag = f"[train {net} 1x64x128 fp32]"
    batch = train_batch(SMALL[:3], torch.Generator().manual_seed(4), "cpu")
    (ref_loss, ref_grads, ref_stats), (loss, grads, stats) = (
        small_step(net, d, batch) for d in ("cpu", "cuda"))
    hold_loss(tag, loss, ref_loss)
    hold_tensors(tag, "BN running statistic", stats, ref_stats)
    if net == "sdnet_mini_ext":
        noise = {}
        for device in ("cpu", "cuda"):
            noisy = grads_at_perturbed_weights(device, batch)
            noise[device] = rel_l2({n: noisy[n] for n in ref_grads if n in noisy},
                                   {n: ref_grads[n] for n in ref_grads if n in noisy})
        diff = rel_l2(grads, ref_grads)
        print(f"{tag} gradients card vs CPU: ||d|| / ||ref|| = {diff:.4g} over {len(ref_grads)} "
              f"tensors; fp32 noise (1e-7 weight perturbation): CPU {noise['cpu']:.4g}, card "
              f"{noise['cuda']:.4g}; tolerance {2 * sum(noise.values()):.4g} = 2 * (CPU + card noise)",
              flush=True)
        check(diff <= 2 * sum(noise.values()),
              f"small train step: gradients off the CPU's by {diff}, noise {noise}")

    tag = f"[train {net} 1x64x128 fp32 freeze_bn, images x 1e-2]"
    small = dict(batch, left=batch["left"] * 1e-2, right=batch["right"] * 1e-2)
    ref_loss, ref_grads, _ = small_step(net, "cpu", small, freeze_bn=True)
    for setting, flags in CUDNN_SETTINGS.items():
        convs = {}
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, **flags):
            grads = small_step(net, "cuda", small, freeze_bn=True, convs=convs)[1]
            # the tensor farthest from the CPU's, and the image convolutions'
            # weights (the first layer's gradient sums over every pixel)
            rel, worst = worst_tensor(grads, ref_grads)
            names = [worst] + sorted(n for n in ref_grads if n.startswith("conv2d_ba") and n != worst)
            for name in names:
                module = name.rsplit(".", 1)[0]
                probe = (wgrad_probe(convs["_model"].get_submodule(module), convs[module])
                         if module in convs and name.endswith(".weight") else None)
                rel = worst_tensor({name: grads[name]}, {name: ref_grads[name]})[0]
                print(f"{tag} cuDNN {setting}: {name}{' (the farthest)' if name == worst else ''} "
                      f"at max|d| = {rel:.3g} * max|ref| from the CPU's" + (
                          f"; its weight gradient alone on the card from the same inputs against "
                          f"float64: {probe[1]:.3g} * max|ref|, kernels {probe[0]}" if probe else ""),
                      flush=True)
    with torch.backends.cudnn.flags(enabled=False):
        loss, grads, _ = small_step(net, "cuda", small, freeze_bn=True)
    tag += " cuDNN off"
    hold_loss(tag, loss, ref_loss)
    hold_tensors(tag, "gradient", grads, ref_grads)


def phase_train(net: str, n_warmup: int, n_steps: int, card: str):
    """Train ``net`` at full width (bf16 policy, the bench loss stack, Adam);
    returns each kernel's launches in the timed steps, the counts set to 0
    just before them."""
    kernels = counters()
    expect = TRAIN[net]
    _, state, step = train_setup(net, "cuda", bf16=True)
    g = torch.Generator(device="cuda").manual_seed(5)
    batches = [train_batch((TRAIN_BATCH, TRAIN_H, TRAIN_W), g, "cuda")
               for _ in range(n_warmup + n_steps)]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i, batch in enumerate(batches):
        if i == n_warmup:
            for k in kernels.values():
                k.launches = 0
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
              f"train {net} step {i}: a metric or loss is not finite: {metrics}")
    launches = {name: k.launches for name, k in kernels.items()}
    for name, per_step in expect.items():
        check(launches[name] == per_step * n_steps,
              f"train {net}: {name} launched {launches[name]} times in {n_steps} steps, "
              f"expected {per_step} per step")
    timed = times[n_warmup:]
    ms = 1e3 * sum(timed) / len(timed)
    print(f"[train {net}] {trunk_name(run_config(net))} bf16, CE + Lovasz + MultiTversky + OHEM, Adam, "
          f"{TRAIN_BATCH} pairs of {TRAIN_H}x{TRAIN_W}: {ms:.2f} ms/step, "
          f"{TRAIN_BATCH / ms * 1e3:.2f} training pairs/s over {len(timed)} steps (per step: "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times)} ms, the first {n_warmup} warm-ups); "
          f"losses {', '.join(f'{v:.5g}' for v in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {card}",
          flush=True)
    return launches


def phase_serve(net: str, n_batches: int, expect: dict):
    """Serve ``n_batches`` batches (the first a warm-up, not timed) and check
    each kernel's launches against ``expect`` (name -> launches per batch)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
        compute_metrics,
        make_forward_fn,
    )

    cfg = run_config(net, bf16=True)
    model = models.get_network(cfg, seed=0)
    forward = make_forward_fn(cfg, model)
    g = torch.Generator(device="cuda").manual_seed(2)
    batches = []
    for _ in range(n_batches):
        labels = torch.randint(0, 2, (BATCH, H, W), device="cuda", generator=g)
        batches.append({
            "left": torch.randn((BATCH, H, W, 3), device="cuda", generator=g),
            "right": torch.randn((BATCH, H, W, 3), device="cuda", generator=g),
            "seg": torch.nn.functional.one_hot(labels, 3).float(),
            "disp": torch.rand((BATCH, H, W, 1), device="cuda", generator=g) * 0.9 + 0.1,
        })
    kernels = {name: wrapper(name) for name in expect}
    torch.cuda.synchronize()
    # no garbage and no cached blocks from an earlier phase: the objects the
    # kernel and small-forward phases leave would otherwise bring on a full
    # collection inside a timed batch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    times = []
    with torch.inference_mode():
        for batch in batches:
            t0 = time.perf_counter()
            out = forward(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for k, shape in (("seg1", 2), ("seg2", 2), ("disp1", 1), ("disp2", 1)):
                check(tuple(out[k].shape) == (BATCH, H, W, shape) and out[k].dtype == torch.float32,
                      f"serve {net}: {k} has shape {tuple(out[k].shape)} {out[k].dtype}")
                check(bool(torch.isfinite(out[k]).all()), f"serve {net}: {k} is not finite")
            metrics = compute_metrics(cfg, out, batch)
    launches = {name: k.launches for name, k in kernels.items()}
    for name, per_batch in expect.items():
        check(launches[name] == per_batch * n_batches,
              f"serve {net}: {name} launched {launches[name]} times in {n_batches} batches, "
              f"expected {per_batch} per batch")
    metrics = {k: v.tolist() for k, v in metrics.items()}
    check(metrics["conf1"] and sum(map(sum, metrics["conf1"])) == BATCH * H * W,
          f"serve {net}: confusion matrix does not count every pixel")
    check(all(torch.isfinite(torch.tensor(v)).all() for v in metrics.values()),
          f"serve {net}: a metric is not finite")
    timed = times[1:]
    ms = 1e3 * sum(timed) / len(timed)
    print(f"[serve {net}] metrics of the last batch: {json.dumps(metrics)}", flush=True)
    print(f"[serve {net}] {trunk_name(cfg)} bf16, {BATCH} pairs of {H}x{W}: "
          f"{ms:.2f} ms/batch, {BATCH / ms * 1e3:.2f} pairs/s over {len(timed)} batches "
          f"(per batch: {', '.join(f'{1e3 * t:.2f}' for t in times)} ms, the first a warm-up); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    return launches


def cli_run(argv, kernels: dict):
    """``cli.train.main(argv)`` on the card with every kernel's count set to 0
    just before; returns (session, its stdout, each kernel's launches). The
    output is printed too."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.cli import train as cli

    for k in kernels.values():
        k.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        session = cli.main(argv)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    text = out.getvalue()
    print(text, end="", flush=True)
    return session, text, launches


def hold_cli_launches(tag: str, session, launches: dict, sites: int = 1) -> None:
    """corr1d's forward once a train step and once an eval forward (one a
    reported row: the eval step runs each row alone and skips the padded
    tail), its backward once a train step, corr2d's kernels never; each
    ``sites`` times (2 at aspp 2)."""
    t = session.timings
    steps = len(t["step_s"])
    forwards = t["eval_rows"]
    expect = {"corr1d": sites * (steps + forwards), "corr1d_backward": sites * steps, "corr2d": 0,
              "corr2d_backward": 0}
    check(launches == expect, f"{tag}: launches {launches}, expected {expect} "
          f"({steps} train steps, {forwards} eval forwards)")


def step_times(t: dict) -> str:
    """Each train step's ms with loading, and the loader's wait in it."""
    return ", ".join(f"{1e3 * s:.1f} (wait {1e3 * w:.1f})" for s, w in zip(t["step_s"], t["load_wait_s"]))


def same_tensors(tag: str, got: dict, ref: dict) -> None:
    check(set(got) == set(ref), f"{tag}: other names")
    for k, v in ref.items():
        if isinstance(v, dict):
            same_tensors(f"{tag}.{k}", got[k], v)
        elif isinstance(v, torch.Tensor):
            check(torch.equal(got[k], v), f"{tag}: {k} differs")
        elif isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            check(all(torch.equal(a, b) for a, b in zip(got[k], v)), f"{tag}: {k} differs")
        else:
            check(got[k] == v, f"{tag}: {k} is {got[k]!r}, saved {v!r}")


def phase_files(card: str):
    """Phase 8: the flagship trained, resumed and evaluated from PNG files
    through the CLI; returns each kernel's launches in the first training
    run (its 4 train steps and its eval)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config_from_args
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import (
        datasets,
        make_roses_fixture,
        native,
        png,
    )
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session

    correlation = correlation_module()
    kernels = {"corr1d": correlation.correlation1d_cuda,
               "corr1d_backward": correlation.correlation1d_backward_cuda,
               "corr2d": correlation.correlation2d_cuda,
               "corr2d_backward": correlation.correlation2d_backward_cuda}
    tmp = tempfile.mkdtemp(prefix="pmt_files_")
    try:
        t0 = time.perf_counter()
        m = make_roses_fixture(os.path.join(tmp, "ds"), n_train=FILES_TRAIN_PAIRS,
                               n_test=FILES_TEST_PAIRS, hw=FILES_HW, seed=0)
        print(f"[files] roses fixture: {FILES_TRAIN_PAIRS} training and {FILES_TEST_PAIRS} test pairs "
              f"of {FILES_HW[0]}x{FILES_HW[1]} in {time.perf_counter() - t0:.2f} s", flush=True)
        rgb = png.read(os.path.join(tmp, "ds", "train_left_0.png"))
        paeth = os.path.join(tmp, "paeth.png")
        png.write(paeth, rgb, filter="paeth")
        for name, path in (("Sub rows, as cv2 writes them", os.path.join(tmp, "ds", "train_left_0.png")),
                           ("Paeth rows", paeth)):
            t0 = time.perf_counter()
            check(bool((png.read(path) == rgb).all()), f"png decode of {name}")
            print(f"[files] the port's PNG decoder: a {FILES_HW[0]}x{FILES_HW[1]} RGB image with "
                  f"{name} in {1e3 * (time.perf_counter() - t0):.1f} ms (host)", flush=True)
        data = []
        for flag, key in (("-colorL", "left"), ("-colorR", "right"), ("-seg", "seg"), ("-disp", "disp"),
                          ("-inst", "inst")):
            data += [flag, m[key], flag + "_test", m[key + "_t"]]
        save = os.path.join(tmp, "runs")
        argv = data + FILES_TRAIN + ["-w_savePath", save]

        # train 2 epochs (2 steps each), then the per-row eval
        datasets.DECODERS.clear()
        session, _, train_launches = cli_run(argv, kernels)
        decoders = sorted(set(datasets.DECODERS))
        check(decoders in (["native"], ["png"]), f"decoders {datasets.DECODERS}")
        cfg = session.cfg
        ckpt = os.path.join(save, cfg.model_id())
        files = sorted(os.listdir(ckpt))
        best = [f for f in files if f.startswith("model_best_IOU") and "_Derr" in f]
        check("meta_1.json" in files and "best.json" in files and len(best) == 1,
              f"checkpoint directory {ckpt}: {files}")
        t = session.timings
        check(len(t["step_s"]) == 4 and t["eval_batches"] == 1 and t["eval_rows"] == FILES_TEST_PAIRS,
              f"train: {t}")
        hold_cli_launches("[files train]", session, train_launches)
        print(f"[files train] flagship densenet121 bf16 from {decoders[0]}-decoded PNGs, 8 pairs of "
              f"256x512 a step: {1e3 * sum(t['step_s'][1:]) / 3:.2f} ms/step with loading over steps "
              f"2-4, of which the loader wait {1e3 * sum(t['load_wait_s'][1:]) / 3:.2f} ms/step (each "
              f"step, ms: {step_times(t)}; the first builds corr1d and warms cuDNN); eval of "
              f"{t['eval_rows']} pairs in "
              f"one batch of 8 at 512x960: {t['eval_rows'] / t['eval_s']:.2f} pairs/s; checkpoint "
              f"{os.path.basename(ckpt)}: {files}; launches {train_launches}; {card}", flush=True)

        # the checkpoint restores bit-equal into a fresh session
        fresh = Session(config_from_args(argv + ["-e", "3", "-load_weights", ckpt]))
        fresh.init_state(steps_per_epoch=2)
        check(fresh.restore(ckpt)[0] == 2, "restore: start epoch")
        same_tensors("[files restore] model", fresh.model.state_dict(), session.model.state_dict())
        same_tensors("[files restore] optimizer", fresh.state.optimizer.state_dict(),
                     session.state.optimizer.state_dict())
        check(fresh.state.step == session.state.step == 4, "restore: step")
        print("[files restore] weights, BatchNorm statistics, optimizer state and step bit-equal to "
              "the trained session's", flush=True)
        del fresh

        # resume to -e 3: one more epoch
        resumed, text, launches = cli_run(argv + ["-e", "3", "-load_weights", ckpt], kernels)
        check("resuming at epoch 2" in text, "resume: no 'resuming at epoch 2'")
        t = resumed.timings
        check(len(t["step_s"]) == 2 and resumed.state.step == 6, f"resume: {t}, step {resumed.state.step}")
        hold_cli_launches("[files resume]", resumed, launches)
        print(f"[files resume] resumed at epoch 2, one epoch: {1e3 * sum(t['step_s']) / 2:.2f} "
              f"ms/step with loading, loader wait {1e3 * sum(t['load_wait_s']) / 2:.2f} ms/step "
              f"({step_times(t)}); "
              f"launches {launches}", flush=True)
        del session, resumed

        # the eval CLI at two batch sizes, then tiled
        summaries = {}
        for b in FILES_EVAL_BATCHES:
            ev, _, launches = cli_run(data + FILES_TRAIN + ["-train", "0", "-b", str(b),
                                                            "-load_weights", ckpt], kernels)
            t = ev.timings
            hold_cli_launches(f"[files eval -b {b}]", ev, launches)
            check(t["eval_rows"] == FILES_TEST_PAIRS, f"eval -b {b}: {t}")
            rows = ev.accumulator.rows
            summaries[b] = (dict(ev.eval_summary),
                            {k: (float(np.mean([r[k] for r in rows])), float(np.std([r[k] for r in rows])))
                             for k in rows[0]})
            print(f"[files eval -b {b}] {t['eval_batches']} batches: {t['eval_rows'] / t['eval_s']:.2f} "
                  f"pairs/s (host, loading included); launches {launches}; {card}", flush=True)
            del ev
        (a, ms_a), (b, ms_b) = (summaries[k] for k in FILES_EVAL_BATCHES)
        check(set(a) == set(b) and ms_a.keys() == ms_b.keys(), "eval summaries of other keys")
        # the per-row mean±std table and the pooled summary
        for k, (mean, std) in ms_a.items():
            a[f"{k} mean"], a[f"{k} std"] = mean, std
            b[f"{k} mean"], b[f"{k} std"] = ms_b[k]
        rel = {k: abs(a[k] - b[k]) / max(abs(a[k]), abs(b[k]), 1e-12) for k in a}
        worst = max(rel, key=rel.get)
        print(f"[files eval] -b {FILES_EVAL_BATCHES[0]} vs -b {FILES_EVAL_BATCHES[1]}: the farthest of "
              f"{len(rel)} summary values {worst} at {rel[worst]:.3g} relative (tolerance "
              f"{FILES_EVAL_RTOL:g})", flush=True)
        check(rel[worst] <= FILES_EVAL_RTOL, f"eval summaries differ: {worst} {a[worst]} vs {b[worst]}")
        ev, _, launches = cli_run(data + FILES_TRAIN + ["-train", "0", "-b", "5", "-slide_window", "1",
                                                        "-load_weights", ckpt], kernels)
        t = ev.timings
        hold_cli_launches("[files tiled]", ev, launches)
        print(f"[files tiled] -slide_window 1: {FILES_WINDOWS} windows of 256x512 an image in one "
              f"batched forward, {t['eval_rows']} forwards: "
              f"{t['eval_rows'] / t['eval_s']:.2f} pairs/s; launches {launches}", flush=True)
        reason = native.unavailable_reason() or "not tried"
        print(f"[files] PNG decoder: {decoders[0]} ("
              + ("the port's own codec, data/png.py; the native library: " + reason.splitlines()[0]
                 if decoders == ["png"] else "the native library built from native/pmt_dataio.cc")
              + ")", flush=True)
        return train_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_option_forward(run: str, tag: str = "options", expect: dict = None) -> None:
    """Phases 9-11: the eval forward of a configuration on the card against
    the CPU at 1x64x128 in fp32, through ``make_forward_fn`` (HANet's grids,
    the multitask ground truth, the edge map, the edge nets' ``left_e`` and
    the ground-truth disparity of ``dsnet_warp_disp`` come from the batch),
    each output and each multitask term within 1e-3 * max|ref|; ``expect``
    (kernel -> launches), the card forward's launches, the counts set to 0
    just before it. The warp nets warp by their own disparity, which at
    random init reaches ~2e3 pixels: its fp32 noise between the devices
    (~1e-2 pixels, within the bound) would move each warped sample by the
    map's slope times that. So the CPU's forward warps at the card's
    offsets (``warp_offsets``), and the disparity itself is held as an
    output."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_forward_fn

    cfg = run_config(run)
    batch = train_batch(SMALL[:3], torch.Generator().manual_seed(1), "cpu", edges=needs_edges(cfg))
    outs, offsets = {}, []
    for device in ("cuda", "cpu"):
        model = models.get_network(cfg, device=device, seed=0)
        forward = make_forward_fn(cfg, model, device)
        for name in (expect or {}):
            wrapper(name).launches = 0
        warps = warp_offsets(record=offsets) if device == "cuda" else warp_offsets(replay=offsets)
        with torch.inference_mode(), warps:
            outs[device] = forward(batch)
        if device == "cuda":
            launches = {name: wrapper(name).launches for name in (expect or {})}
    check(launches == (expect or {}), f"[{tag} {run}] card forward launches {launches}, "
          f"expected {expect}")
    ref, got = outs["cpu"], outs["cuda"]
    check(set(got) == set(ref), f"[{tag} {run}] outputs {sorted(got)} vs {sorted(ref)}")
    pairs = [(k, got[k], ref[k]) for k in ref if k != "mt"]
    pairs += [(f"mt[{i}]", a, b) for i, (a, b) in enumerate(zip(got.get("mt", ()), ref.get("mt", ())))]
    worst = []
    for k, a, b in pairs:
        err = (a.cpu() - b).abs().max().item()
        bound = 1e-3 * b.abs().max().item()
        check(err <= bound, f"[{tag} {run}] forward {k}: card vs CPU max|d| {err} > {bound}")
        worst.append((err / bound if bound else 0.0, k))
    print(f"[{tag} {run}] {trunk_name(cfg)}, 1x64x128 fp32 forward, card vs CPU: {len(pairs)} "
          f"outputs within 1e-3 * max|ref|; the closest to its bound: {max(worst)[1]} at "
          f"{max(worst)[0]:.3g} of it" + (f"; launches {launches}" if launches else "")
          + (f"; {len(offsets)} warps at the card's offsets" if offsets else ""), flush=True)


@contextlib.contextmanager
def warp_offsets(record: list = None, replay: list = None):
    """The warp nets' disparity warps (``models.warpnets.apply_disparity``):
    with ``record``, each call's offsets are appended to it (on the host);
    with ``replay``, the i-th call warps at the i-th recorded offsets instead
    of its own."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import warpnets

    original = warpnets.apply_disparity
    calls = iter(replay) if replay is not None else None

    def patched(images, offset):
        if record is not None:
            record.append(offset.detach().cpu())
        if calls is not None:
            offset = next(calls).to(offset.device, offset.dtype)
        return original(images, offset)

    warpnets.apply_disparity = patched
    try:
        yield
    finally:
        warpnets.apply_disparity = original


def finite_step(run: str, losses=TRAIN_LOSSES, tag: str = None, dataset: str = "roses") -> float:
    """One bf16 train step of the run at 8x256x512 on the card (Adam):
    finite loss, metrics and gradients, and its correlation's forward and
    backward kernels launched once each (``one_correlation``, the counts set
    to 0 just before the step); returns its ms (the first step of a model,
    so with cuDNN's first calls)."""
    model, state, step = train_setup(run, "cuda", bf16=True, losses=losses, dataset=dataset)
    batch = train_batch((TRAIN_BATCH, TRAIN_H, TRAIN_W), torch.Generator(device="cuda").manual_seed(8),
                        "cuda", dataset, edges=needs_edges(run_config(run)))
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {name: k.launches for name, k in kernels.items()}
    tag = tag or f"[options {run}]"
    check(launches == one_correlation(run, step=True),
          f"{tag} train step launches {launches}, expected {one_correlation(run, step=True)}")
    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
          f"{tag} train step: a metric or loss is not finite: {metrics}")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    check(bool(grads) and all(bool(torch.isfinite(g).all()) for g in grads),
          f"{tag} train step: a gradient is not finite")
    print(f"{tag} one bf16 train step, {TRAIN_BATCH} pairs of {TRAIN_H}x{TRAIN_W}, losses "
          f"{'+'.join(losses)}: loss {metrics['loss'].item():.6g}, {len(grads)} finite gradient "
          f"tensors, {ms:.1f} ms (first step); launches {launches}", flush=True)
    del model, state, step
    return ms


def stack_loss(stack, dataset: str, out: dict, batch: dict, uniform: torch.Tensor) -> torch.Tensor:
    """Head 1's cross entropy, head 2's ``stack`` and the disparity stack, as
    ``make_losses_fn`` composes them, with dual_edge_reg's uniform sample
    given."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.losses import (
        compose_disp_loss,
        compose_seg_loss,
    )

    n = out["seg1"].shape[-1]
    head1 = compose_seg_loss(["cross_entropy"], dataset, n)
    head2 = compose_seg_loss(stack, dataset, n)
    disp = compose_disp_loss(stack, dataset, "smallOutSeg")
    return (head1(out["seg1"], batch["seg"]) + head2(out["seg2"], batch["seg"], uniform=uniform)
            + disp(batch["disp"], out["disp1"], batch["left"], batch["seg"]))


def phase_loss_stack(stack, dataset: str) -> None:
    """Phase 9: a loss stack's fp32 value on the card against the CPU at
    LOSS_SHAPE (the same outputs, ground truth and uniform sample), then one
    bf16 train step of the flagship with it."""
    g = torch.Generator().manual_seed(11)
    batch = train_batch(LOSS_SHAPE, g, "cpu", dataset)
    n = 2 if dataset == "roses" else 19
    out = {"seg1": 2 * torch.randn(LOSS_SHAPE + (n,), generator=g),
           "seg2": 2 * torch.randn(LOSS_SHAPE + (n,), generator=g),
           "disp1": torch.randn(LOSS_SHAPE + (1,), generator=g)}
    uniform = torch.rand(LOSS_SHAPE + (n,), generator=g)
    ref = stack_loss(stack, dataset, out, batch, uniform).item()
    got = stack_loss(stack, dataset, {k: v.cuda() for k, v in out.items()},
                     {k: v.cuda() for k, v in batch.items()}, uniform.cuda()).item()
    err = abs(got - ref)
    print(f"[losses {'+'.join(stack)}] {dataset}, fp32 at {LOSS_SHAPE}: card {got:.8g}, CPU {ref:.8g}, "
          f"|d| = {err:.3g} (tolerance {LOSS_RTOL * abs(ref):.3g} = {LOSS_RTOL:g} * |ref|)", flush=True)
    check(err <= LOSS_RTOL * abs(ref), f"loss stack {stack}: card {got} vs CPU {ref}")
    finite_step("sdnet_mini_ext", stack, tag=f"[losses {'+'.join(stack)}]", dataset=dataset)


def phase_restore(card: str) -> dict:
    """Phase 9: the aspp-2 flagship restores from a reference ``.pth.tar``
    through the eval CLI bit-equal (``restore_through_cli``, corr1d twice an
    eval forward); then ``-pretrained_path`` with a torchvision-layout
    densenet121: every trunk tensor equal after the load. Returns the eval's
    launches."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.densenet import (
        DenseNetFeatures,
    )
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session

    tmp = tempfile.mkdtemp(prefix="pmt_restore_")
    try:
        launches, _ = restore_through_cli("flagship_aspp2", ["-aspp", "2"], card, tmp, sites=2)

        # -pretrained_path: a torchvision-layout densenet121 into the trunk
        trunk = models.init_parameters(DenseNetFeatures(), torch.Generator().manual_seed(9))
        tv = {"features." + k: v for k, v in trunk.state_dict().items()}
        tv.update({"classifier.weight": torch.zeros(1000, 1024), "classifier.bias": torch.zeros(1000)})
        tv_path = os.path.join(tmp, "densenet121.pth")
        torch.save(tv, tv_path)
        cfg = run_config("flagship_aspp2", bf16=True)
        cfg.model.pretrained_path = tv_path
        fresh = Session(cfg)
        fresh.init_state()
        got = fresh.model.features.backbone.state_dict()
        names = [k for k in trunk.state_dict() if not k.endswith("num_batches_tracked")]
        for k in names:
            check(torch.equal(got[k].cpu(), trunk.state_dict()[k]), f"pretrained: {k} differs")
        print(f"[pretrained] -pretrained_path with a torchvision densenet121 dict: all {len(names)} "
              f"trunk tensors equal after the load", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_options(card: str) -> dict:
    """Phase 9: the flagship family's options on densenet121 at full width
    and depth. The aspp-2 flagship serves (16 pairs of 512x960, corr1d twice
    a batch) and trains (8 pairs of 256x512, corr1d and its backward twice a
    step); every configuration of ``OPTIONS`` runs its fp32 forward on the
    card against the CPU and one bf16 train step; each of ``LOSS_STACKS``
    holds its loss value and trains; a reference ``.pth.tar`` restores
    bit-equal. Returns the launches of each path."""
    serve = phase_serve("flagship_aspp2", *SERVE["flagship_aspp2"])
    train = phase_train("flagship_aspp2", TRAIN_WARMUP, TRAIN_STEPS, card)
    for run in OPTIONS:
        phase_option_forward(run, expect=SERVE["flagship_aspp2"][1] if run == "flagship_aspp2"
                             else one_correlation(run))
        if run != "flagship_aspp2":  # trained above
            finite_step(run)
    for stack, dataset in LOSS_STACKS:
        phase_loss_stack(stack, dataset)
    return {"serve": serve, "train": train, "restore": phase_restore(card)}


def phase_trunk_restore(card: str) -> dict:
    """Phase 10: a resnet101 flagship restores from a reference ``.pth.tar``
    (the dilated ResNet's ``conv1``/``layer{l}.{b}`` keys, ``aspp_4``)
    through the eval CLI bit-equal (``restore_through_cli``); then
    ``-pretrained_path`` grafts a MobileNetV3-Large in cuevhv's layout
    (``features.N``, a classifier ignored) into a mobilenet flagship's trunk.
    Returns the eval's launches."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.mobilenetv3 import (
        MobileNetV3LargeFeatures,
    )
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import

    tmp = tempfile.mkdtemp(prefix="pmt_trunk_restore_")
    try:
        launches, ref = restore_through_cli("flagship_resnet101", ["-backbone", "resnet101"], card, tmp)
        check("aspp_4.conv1.weight" in ref and
              "resnet_features.resnet_features.layer3.22.conv3.weight" in ref,
              "trunk restore: the reference dict lacks ResNet-101's or aspp_4's keys")

        trunk = models.init_parameters(MobileNetV3LargeFeatures(), torch.Generator().manual_seed(9))
        holder = torch.nn.Module()
        holder.bb = trunk
        sd = torch_import.export_state_dict(holder, torch_import.backbone_entries(trunk, "bb", ""))
        sd.update({"classifier.0.weight": torch.zeros(1280, 960),
                   "classifier.0.bias": torch.zeros(1280)})
        mb_path = os.path.join(tmp, "mobilenetv3-large.pth")
        torch.save(sd, mb_path)
        cfg = run_config("flagship_mobilenet", bf16=True)
        cfg.model.pretrained_path = mb_path
        fresh = Session(cfg)
        fresh.init_state()
        got = fresh.model.features.backbone.state_dict()
        names = [k for k in trunk.state_dict() if not k.endswith("num_batches_tracked")]
        for k in names:
            check(torch.equal(got[k].cpu(), trunk.state_dict()[k]), f"pretrained mobilenet: {k} differs")
        print(f"[pretrained] -pretrained_path with a MobileNetV3-Large in cuevhv's layout "
              f"({len(sd)} keys): all {len(names)} trunk tensors equal after the load", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_trunks(card: str) -> dict:
    """Phase 10: the zoo's trunks and the nets built on them at full width
    and depth. The flagship on resnet101 and the dlab net serve 16 pairs of
    512x960 (corr1d once a batch) and train at 8x256x512 (corr1d and its
    backward once a step); every other trunk under the flagship runs its
    fp32 forward card vs CPU at 1x64x128, one bf16 train step and one timed
    serving batch; the Ext_small nets, -edges on the flagship and sdnetv2,
    and the dlab net with 2dcorr (corr2d once a forward) run card vs CPU
    and one bf16 step; a resnet101 ``.pth.tar`` restores bit-equal and a
    MobileNetV3-Large grafts. Returns the launches of each path."""
    paths = {}
    for run in TRUNK_PATHS:
        paths[f"{run}_serve"] = phase_serve(run, *SERVE[run])
        paths[f"{run}_train"] = phase_train(run, TRAIN_WARMUP, TRAIN_STEPS, card)
    for b in OTHER_TRUNKS:
        run = f"flagship_{b}"
        phase_option_forward(run, "trunks", one_correlation(run))
        finite_step(run, tag=f"[trunks {run}]")
        phase_serve(run, TRUNK_SERVE_BATCHES, {"corr1d": 1, "corr2d": 0})
    for run in EDGE_RUNS:
        phase_option_forward(run, "trunks", one_correlation(run))
        finite_step(run, tag=f"[trunks {run}]")
    paths["restore"] = phase_trunk_restore(card)
    return paths


def phase_zoo_tta() -> None:
    """Phase 11: ``-tta 1 -tta_scales 0.75 1.25`` on ``deeplab`` through the
    eval step, card against CPU (fp32, 2 rows of 64x128, the same weights):
    the averaged seg heads within 1e-3 * max|ref|, no correlation launched."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_eval_step

    cfg = run_config("deeplab")
    cfg.run.tta, cfg.run.tta_scales = True, TTA_SCALES
    batch = train_batch((2,) + SMALL[1:3], torch.Generator().manual_seed(14), "cpu")
    outs = {}
    for device in ("cpu", "cuda"):
        step = make_eval_step(cfg, models.get_network(cfg, device=device, seed=0), device)
        for k in counters().values():
            k.launches = 0
        outs[device] = step(batch)[0]
    launches = {name: k.launches for name, k in counters().items()}
    check(not any(launches.values()), f"[zoo tta] launches {launches}")
    ref, got = outs["cpu"]["seg1"], outs["cuda"]["seg1"].cpu()
    check(torch.equal(outs["cuda"]["seg1"], outs["cuda"]["seg2"]), "[zoo tta] seg2 is not seg1")
    err, bound = (got - ref).abs().max().item(), 1e-3 * ref.abs().max().item()
    print(f"[zoo tta] deeplab -tta 1 -tta_scales {' '.join(map(str, TTA_SCALES))}, eval step on 2 "
          f"rows of 1x64x128 fp32, card vs CPU: seg1 max|d| = {err:.6g} (tolerance {bound:.6g} = "
          f"1e-3 * max|ref|)", flush=True)
    check(err <= bound, f"[zoo tta] seg1: {err} > {bound}")


def restore_through_cli(run: str, flags, card: str, tmp: str, sites: int = 1):
    """A run's seeded weights (seed 7) written in the reference's layout as
    a ``.pth.tar`` (``{"state_dict": {"module." + key: tensor}, "epoch": 0}``,
    the port's importer inverted), restored through the eval CLI
    (``-load_weights x.pth.tar -train 0`` on a 2+2-pair fixture, ``flags``
    naming the run's net and options): the CLI's net and trunk are the
    run's, corr1d launched ``sites`` times an eval forward, every tensor and
    the bf16 outputs at 1x512x960 bit-equal to the source model's on the
    card. Returns (the eval's launches, the reference-layout dict)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import make_roses_fixture
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_forward_fn
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import

    cfg = run_config(run, bf16=True)
    source = models.get_network(cfg, seed=7)
    ref = torch_import.export_state_dict(source, torch_import.entries_for(cfg, source))
    path = os.path.join(tmp, f"{run}.pth.tar")
    torch.save({"state_dict": {"module." + k: v for k, v in ref.items()}, "epoch": 0}, path)
    m = make_roses_fixture(os.path.join(tmp, f"ds_{run}"), n_train=2, n_test=2, hw=(256, 512), seed=0)
    data = []
    for flag, key in (("-colorL", "left"), ("-colorR", "right"), ("-seg", "seg"), ("-disp", "disp"),
                      ("-inst", "inst")):
        data += [flag, m[key], flag + "_test", m[key + "_t"]]
    argv = data + FILES_TRAIN + list(flags) + ["-train", "0", "-b", "2", "-load_weights", path,
                                               "-w_savePath", os.path.join(tmp, "runs")]
    session, _, launches = cli_run(argv, counters())
    tag = f"[restore {run}]"
    check((session.cfg.model.net, session.cfg.model.backbone) == (cfg.model.net, cfg.model.backbone),
          f"{tag} the CLI's net and trunk")
    check(session.timings["eval_rows"] == 2, f"{tag} {session.timings}")
    hold_cli_launches(tag, session, launches, sites)
    mine, theirs = session.model.state_dict(), source.state_dict()
    check(set(mine) == set(theirs), f"{tag} other tensor names")
    for k, v in theirs.items():
        check(k.endswith("num_batches_tracked") or torch.equal(mine[k], v), f"{tag} {k} differs")
    batch = train_batch((1, H, W), torch.Generator(device="cuda").manual_seed(12), "cuda")
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                                            benchmark=False, allow_tf32=False):
        a = make_forward_fn(session.cfg, session.model)(batch)
        b = make_forward_fn(session.cfg, source)(batch)
    for k in ("seg1", "seg2", "disp1", "disp2"):
        check(torch.equal(a[k], b[k]), f"{tag} output {k} differs from the source model's")
    print(f"{tag} {trunk_name(cfg)}, from a reference-layout .pth.tar ({len(ref)} tensors, "
          f"'module.' prefix, 'state_dict' wrapper) through the eval CLI: every weight and "
          f"statistic and the bf16 outputs at 1x{H}x{W} bit-equal to the source model's; "
          f"launches {launches}; {card}", flush=True)
    return launches, ref


def phase_zoo_restore(card: str) -> dict:
    """Phase 11: ``deeplab_mod`` and ``dsnet_warp`` restore from reference
    ``.pth.tar`` files through the eval CLI (``restore_through_cli``); then
    ``-pretrained_path`` with a bare Xception-65 dict (unprefixed keys and a
    classifier, as ``load_url`` gives it) grafts every encoder tensor of
    ``deeplab``. Returns each restore's launches."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.deeplab import Xception65
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import

    tmp = tempfile.mkdtemp(prefix="pmt_zoo_restore_")
    try:
        launches = {run: restore_through_cli(run, ["-net", RUNS[run][0]], card, tmp)[0]
                    for run in ("deeplab_mod", "dsnet_warp")}
        encoder = models.init_parameters(Xception65(), torch.Generator().manual_seed(9))
        holder = torch.nn.Module()
        holder.bb = encoder
        sd = torch_import.export_state_dict(holder, torch_import.xception65_entries(encoder, "bb", ""))
        sd.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
        path = os.path.join(tmp, "xception65.pth")
        torch.save(sd, path)
        cfg = run_config("deeplab", bf16=True)
        cfg.model.pretrained_path = path
        fresh = Session(cfg)
        fresh.init_state()
        got, want = fresh.model.encoder.state_dict(), encoder.state_dict()
        names = [k for k in want if not k.endswith("num_batches_tracked")]
        for k in names:
            check(torch.equal(got[k].cpu(), want[k]), f"[zoo pretrained] {k} differs")
        print(f"[zoo pretrained] -pretrained_path with a bare Xception-65 dict ({len(sd)} keys): all "
              f"{len(names)} encoder tensors of deeplab equal after the load", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_zoo(card: str) -> dict:
    """Phase 11: the rest of the CLI's nets at full width and depth. The
    three paths of ``ZOO_PATHS`` serve 16 pairs of 512x960 and train at
    8x256x512 (the bench loss stack, Adam) with their launches held;
    every run of ``ZOO_RUNS`` runs its fp32 forward card vs CPU and one bf16
    train step; deeplab's TTA eval card vs CPU; two ``.pth.tar`` restores
    and an Xception-65 graft. Returns the launches of each path."""
    paths = {}
    for run in ZOO_PATHS:
        paths[f"{run}_serve"] = phase_serve(run, *SERVE[run])
        paths[f"{run}_train"] = phase_train(run, TRAIN_WARMUP, ZOO_TRAIN_STEPS, card)
    for run in ZOO_RUNS:
        phase_option_forward(run, "zoo", one_correlation(run))
        finite_step(run, tag=f"[zoo {run}]")
    phase_zoo_tta()
    paths["restore"] = phase_zoo_restore(card)
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve", choices=sorted(SERVE), help="only serve this net (or flagship_aspp2) "
                    "and time it")
    ap.add_argument("--train", nargs="?", const="sdnet_mini_ext", choices=sorted(TRAIN),
                    help="only train this net (the flagship by default; or flagship_aspp2) and "
                         "time it")
    ap.add_argument("--backward", nargs="?", const="corr1d", choices=sorted(BACKWARDS),
                    help="only hold this backward kernel (corr1d's by default) against its "
                         "plain version at the training and serving shapes and time it")
    ap.add_argument("--kernels", action="store_true",
                    help="only build the kernels and hold them against their plain versions "
                         "(phases 1-2); prints no result line")
    ap.add_argument("--files", action="store_true",
                    help="only train, resume and evaluate the flagship from PNG files through "
                         "the CLI (phase 8)")
    ap.add_argument("--trunks", action="store_true",
                    help="only run the zoo's trunks and the nets built on them (phase 10): the "
                         "resnet101 flagship and the dlab net serve and train, every other trunk, "
                         "the Ext_small nets, -edges, the resnet101 .pth.tar restore")
    ap.add_argument("--options", action="store_true",
                    help="only run the flagship family's options (phase 9): the aspp-2 flagship "
                         "serves and trains, every other configuration and loss stack, the "
                         ".pth.tar restore")
    ap.add_argument("--zoo", action="store_true",
                    help="only run the rest of the CLI's nets (phase 11): deeplab_mod, dsnet_warp "
                         "and pspnet serve and train, every other configuration, deeplab's TTA, "
                         "the .pth.tar restores, the Xception-65 graft")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if (args.serve or args.train or args.backward or args.files or args.options or args.trunks
            or args.zoo):
        try:
            if args.files:
                phase_files(card)
            elif args.zoo:
                phase_zoo(card)
            elif args.trunks:
                phase_trunks(card)
            elif args.options:
                phase_options(card)
            elif args.serve:
                phase_serve(args.serve, SERVE_BATCHES, SERVE[args.serve][1])
            elif args.train:
                phase_train(args.train, TRAIN_WARMUP, 10, card)
            else:
                phase_backward(args.backward, None, BACKWARDS[args.backward][2][:4], autograd=False)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        sass = phase_build()
        records = {name: phase_kernel(name, sass) for name in KERNELS}
        for name in BACKWARDS:
            records[f"{name}_backward"] = phase_backward(name, sass)
        for name in KERNELS:  # the trunks' sites: each case's forward and backward
            sites = phase_sites(name)
            records[name]["sites"] = [
                {k: v for k, v in r.items() if not k.startswith("backward")} for r in sites]
            records[f"{name}_backward"]["sites"] = [
                {k: v for k, v in r.items() if k in ("shape", "dtype", "site") or k.startswith("backward")}
                for r in sites]
        if args.kernels:
            print(json.dumps({"kernels": list(records.values())}), flush=True)
            return 0
        for net, corr_type in (("sdnet_mini_ext", "1dcorr"), ("sdnet", "2dcorr"),
                               ("sdnet_mini_ext", "2dcorr")):
            phase_small_forward(net, corr_type)
        for net in ("sdnet_mini_ext", "sdnet"):
            phase_small_train(net)
        records["corr1d"]["launches"] = phase_serve("sdnet_mini_ext", *SERVE["sdnet_mini_ext"])["corr1d"]
        phase_serve("sdnet", *SERVE["sdnet"])
        # each kernel's launches come from the train step of its path
        for net, names in (("sdnet_mini_ext", ("corr1d_backward",)),
                           ("sdnet", ("corr2d", "corr2d_backward"))):
            launches = phase_train(net, TRAIN_WARMUP, TRAIN_STEPS, card)
            for name in names:
                records[name]["launches"] = launches[name]
        # the launches of the files-through-the-CLI path (2 epochs of 2 steps
        # and one eval batch)
        for name, n in phase_files(card).items():
            records[name]["launches_cli"] = n
        # phase 9: the aspp-2 flagship's launches (two corr1d sites) serving,
        # training and through the eval CLI's restore
        paths = phase_options(card)
        records["corr1d"]["launches_aspp2_serve"] = paths["serve"]["corr1d"]
        records["corr1d"]["launches_aspp2_train"] = paths["train"]["corr1d"]
        records["corr1d"]["launches_aspp2_restore_eval"] = paths["restore"]["corr1d"]
        records["corr1d_backward"]["launches_aspp2_train"] = paths["train"]["corr1d_backward"]
        # phase 10: the resnet101 flagship's and the dlab net's launches
        # (corr1d at C = 608 and 1024) serving and training
        paths = phase_trunks(card)
        for run in TRUNK_PATHS:
            records["corr1d"][f"launches_{run}_serve"] = paths[f"{run}_serve"]["corr1d"]
            records["corr1d"][f"launches_{run}_train"] = paths[f"{run}_train"]["corr1d"]
            records["corr1d_backward"][f"launches_{run}_train"] = paths[f"{run}_train"]["corr1d_backward"]
        records["corr1d"]["launches_trunk_restore_eval"] = paths["restore"]["corr1d"]
        # phase 11: deeplab_mod's (corr1d at its new site), dsnet_warp's and
        # pspnet's launches serving and training, and the restores' evals
        paths = phase_zoo(card)
        for run in ZOO_PATHS:
            records["corr1d"][f"launches_{run}_serve"] = paths[f"{run}_serve"]["corr1d"]
            for name in ("corr1d", "corr1d_backward", "corr2d", "corr2d_backward"):
                records[name][f"launches_{run}_train"] = paths[f"{run}_train"][name]
        for run, launches in paths["restore"].items():
            records["corr1d"][f"launches_{run}_restore_eval"] = launches["corr1d"]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [records[k] for k in ("corr1d", "corr1d_backward", "corr2d",
                                                       "corr2d_backward")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
