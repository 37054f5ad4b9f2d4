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
   transposed band; corr2d's also at its bf16 items' edges, each case
   launched twice and the two results bit-equal), count HMMA in its own
   bf16 function, time it warm and
   with the L2 flushed before each launch, and hold the gradients that
   ``torch.autograd.grad`` takes through ``correlation`` (forward kernel,
   then backward kernel) at the training shape; hold corr1d's fp32 forward
   (``corr1d_fp32_kernel``, the CLI's default precision) at the main paths'
   shapes (``FP32_CORR1D_SHAPES``: serving, a view of the training step, an
   eval row) and time each launch alone, warm, beside its byte bound;
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
   serving-shape forwards against their byte bounds (in fp32 corr1d's
   forward, a launch alone, and its backward, flushed, at every site). The flagship on
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
   and ``-pretrained_path`` grafts an Xception-65 into ``deeplab``;
12. EncoderDecoderNet (``models/encdec.py``, outside the CLI) at the
   reference's full width (resnet50 encoder, ``num_filters`` 16, 19 labels)
   with each decoder type (SCSE, SE-IBN, ObjectContext), the attention's
   ``W`` non-zero: the fp32 forward card vs CPU at 1x64x128 within 1e-3 *
   max|ref|; serving under the bf16 policy (SCSE and SE-IBN at 16x512x960,
   OC at 4x256x512, where its dense attention fits: ``ENCDEC_SERVE``) with
   ms/batch, pairs/s and peak memory; two bf16 train steps with the mono
   deeplab net's seg-only loss on cityscapes labels (8x256x512, OC
   2x256x512) with finite losses and gradients; a reference-layout
   ``.pth.tar`` through ``import_encdec`` bit-equal in weights and bf16
   outputs; no kernel launched on any of these paths. Then
   ``parallel/spatial.py`` on the flagship: the banded forward card vs CPU
   at 1x128x128 within 1e-3 * max|ref|, and at 2x512x960 in 8 bands with a
   64-row halo against the monolithic forward under bf16, max|d| over the
   rows beside the image's top and bottom, the seams and the rest printed
   as a reading, beside the same reading for one band with the halo's zero
   rows and for a halo spanning the whole image (corr1d once a forward
   either way); two controls: one band without a halo is the monolithic
   forward, and the banded forward is each band's own forward put in place
   (fp32, TF32 off), each within 1e-3 * max|ref|;
13. data parallel (``parallel/mesh.py`` over ``torch.distributed``), two
   ranks spawned over gloo, both on the one card (NCCL refuses two ranks on
   one card), the kernels built before they start: (a) fp32, TF32 off, the
   flagship at full width and depth on one pair of 64x128 a rank against
   one process on both pairs from the same weights, with BatchNorm
   cross-replica and per replica: in train mode the loss, the summed
   confusions and every running statistic within 1e-3 * max|ref|; with
   ``freeze_bn`` on images scaled by 1e-2 and cuDNN off, every gradient
   tensor within 1e-3 * max|ref|; (b) the flagship's bf16 step (bench loss
   stack, Adam, cross-replica BatchNorm) on 4 pairs of 256x512 a rank, 2
   warm-up and 4 timed steps: finite, corr1d's forward and backward once a
   step on each rank, the replicas' weights and statistics bit-equal after
   the steps, ms/step printed as a reading (the ranks share the card); (c)
   ``cli.train.main`` in each rank on phase 8's files, one epoch and the
   sharded eval: rank 0 alone prints and writes the checkpoint, a fresh
   one-card ``Session`` restores it bit-equal to rank 0's state, and the
   sharded eval's summary table equals the one-card eval CLI's from that
   checkpoint within 1e-3 relative;
14. the CLI's default precision, fp32 (no ``-f16``), with cuDNN's TF32 as
   the program leaves it (printed): sdnet at full width and depth serves
   16 pairs of 512x960 (a warm-up and 3 timed batches, corr2d's fp32 kernel
   once a batch) and trains at 8x256x512 (2 warm-up and 8 timed steps,
   corr2d's fp32 forward and backward once a step each): ms/batch, pairs/s,
   ms/step, peak memory, finite outputs and losses; then ``cli.train.main``
   without ``-f16`` trains sdnet one epoch of 2 steps on phase 8's files and
   evaluates the 5 test pairs (corr2d once a step and once an eval forward,
   its backward once a step, corr1d never). Phase 2 holds the fp32 kernels
   at their own edges too (4-row blocks, passes, stages; the backward's
   items, channel groups and relayout);
15. the port's learning gate, ``tools/overfit_smoke.py`` (the JAX package's
   ``tools/overfit_smoke.py`` ported with its configuration: ``sdnet_mini``
   on 8 synthetic ROSeS pairs of 96x160, 64x128 crops, batches of 8, Adam
   at 5e-3 for 40 epochs of one step, evaluated on the same 8 pairs), at
   full width and depth, each run a ``Session`` of its own from the seeded
   init, TF32 as the program leaves it: ``sdnet_mini`` in fp32 and under
   the bf16 policy at seeds 0, 1 and 2, the flagship at
   ``scripts/train_flagship.sh``'s flags (CE + Lovász) in fp32 at seed 0,
   and the negative control, ``sdnet_mini`` fp32 with its labels rolled
   along each training batch (``overfit_smoke.LabelFault``). Holds each run
   finite, corr1d once a train step and once an eval row and its backward
   once a train step, exactly; the mIoU of head 2 with BatchNorm on the 8
   pairs' own statistics (``overfit_smoke.batch_statistics_miou``) at least
   ``OVERFIT_HELD_MIOU`` in every run that learns, with its last epoch's
   train loss at most half its first's, and below it in the control.
   Prints each run's tool line (the eval's mIoU of head 2 on the running
   statistics and its ``pass``, mIoU > 0.9), its first and last train loss,
   ms a step and peak memory, and each configuration's medians beside the
   JAX package's CPU readings of the tool (``OVERFIT_JAX_CPU``): readings,
   not held. Phase 2 holds corr1d at this path's shapes (C 352 at W 16 and
   20) too;
16. the repository's launch scripts in the port
   (``pmt_..._torch/scripts/train_flagship.sh`` and ``eval_flagship.sh``,
   the root scripts with the port's CLI module), run unmodified by bash
   from a working directory of their own, each in a process of its own: a
   roses fixture of 8 training, 2 val and 2 test pairs of 256x512 in the
   scripts' manifests, ``reduced_size/*__small.txt`` written by the root
   ``scripts/reduce_existent_dataset.py``; ``train_flagship.sh DATA small``
   trains the flagship in the CLI's default fp32 (CE + Lovász, Adam, 100
   epochs of one step of 8 pairs of 256x512, an eval every 10 epochs), then
   ``eval_flagship.sh DATA CKPT`` evaluates its checkpoint at ``-b 1
   -show_results 1``. A ``python`` first on ``PATH`` starts this script's
   ``script_probe``, which runs the CLI module as it is and records each
   kernel's launches in that process. Holds both scripts exit 0, the
   checkpoint's files, the summary as the eval's last line and its result
   images, every printed loss and metric finite, fp32 on the card, corr1d
   once a train step and once an eval row and its backward once a train
   step; the eval script's summary table equals ``cli.train.main`` run
   here on the arguments the script passed, on the same checkpoint, within
   ``FILES_EVAL_RTOL``. First it holds corr1d's fp32 forward at the path's
   shapes against its plain version and times it. Prints ms a step with
   loading and the loader's wait, eval pairs/s, peak memory and the phase's
   seconds.

Phase 8's eval CLI runs at ``-show_results 1`` (the flag's default): the
summary is printed and both confusion heatmaps decode.

The third-to-last line of stdout is a JSON object with one record per
kernel, the second-to-last the card's name and power limit, and the last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --serve sdnet

only serves one net (phase 4 or 5, with 10 batches) and prints its time,
and ``python3 chip_smoke.py --train [sdnet]`` only trains (phase 6, or 7
with ``sdnet``, 2 warm-up and 10 timed steps); with ``--fp32`` either runs
in fp32 with TF32 as the program leaves it (``--serve sdnet --fp32``), and
``--fp32`` alone runs phase 14 only: copied into the root of
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
like), ``--encdec`` phase 12 only, ``--overfit`` phase 15 only,
``--scripts`` phase 16 only.

    python3 chip_smoke.py --ddp

runs phase 13 over NCCL with one rank on each visible card (it fails with
fewer than two), and then the flagship's bf16 step at 8 pairs of 256x512 a
card on 1, 2 and 4 cards in the same call: ms/step, pairs/s, and the NCCL
kernels' time a step and share of it from a ``utils/profiling.py:trace`` of
two more steps on rank 0; it prints no result line.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import contextlib
import io
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

PORT = "pmt_learning_for_semantic_segmentation_and_disparity_torch"
ROOT = Path(__file__).resolve().parent  # the checkout
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
# corr1d's fp32 forward (the CLI's default precision) on the main paths:
# serving's a_py2, a view's in the training step, and an eval row's (the eval
# step runs each row alone); phase 2 holds each and times a launch alone
FP32_CORR1D_SHAPES = {"serving": CORR_SHAPE, "training step": TRAIN_SHAPE, "eval row": (1, H // 8, W // 8, 352)}
# phase 15's training site: sdnet_mini's a_py2 (C 352 at /8) of one view at
# the overfit tool's 8 crops of 64x128
OVERFIT_TRAIN_CASES = [((8, 8, 16, 352), torch.float32), ((8, 8, 16, 352), torch.bfloat16)]
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
    *OVERFIT_TRAIN_CASES,                   # phase 15: sdnet_mini's 1/8 map a view
]
# corr2d's backward against correlation2d_vjp_plain: the training and
# serving shapes in both dtypes, then edge shapes: H and W against the 8-row
# and 8-column reach of the patch and the 64-column tile (1, 7, 16, 17, 18,
# 65), C against the 64-channel box (16, 24, 352, 360), element staging (C %
# 8 != 0 in bf16, C % 4 != 0 in fp32) and element offsets of the storage (a
# fourth entry: g's own offset where it differs); then the bf16 band's
# items (4 output rows, 128 channels): H = 3, 5, 17 against the 4 rows, C =
# 128, 136, 192 against the channel group and its second box, g's relayout
# by element loads (W % 8 != 0 with 16-byte aligned inputs, g alone off
# 16-byte alignment)
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
    ((1, 3, 64, 64), torch.bfloat16),       # H = 3: one item of 3 rows
    ((1, 5, 64, 64), torch.bfloat16),       # H = 5: items of 4 and 1 rows
    ((1, 17, 40, 64), torch.bfloat16),      # H = 17: F's reach both ways, a last row alone
    ((1, 9, 24, 128), torch.bfloat16),      # C = 128: one channel group
    ((1, 9, 24, 136), torch.bfloat16),      # C = 136: a second group of 8 channels
    ((1, 9, 24, 192), torch.bfloat16),      # C = 192: the second group's second box past C
    ((2, 6, 70, 64), torch.bfloat16),       # W % 8 != 0: g's rows by element loads
    ((1, 9, 64, 64), torch.bfloat16, 0, 1),  # g alone off 16-byte alignment
    # the fp32 band's items (4 output rows, 128 channels) and its relayout
    ((1, 3, 64, 64), torch.float32),        # H = 3: one item of 3 rows
    ((1, 5, 70, 136), torch.float32),       # H = 5: items of 4 and 1 rows; a second group of 8
                                            # channels; W % 8 != 0: g's rows by element loads
    ((1, 9, 24, 200), torch.float32),       # C = 200: a second group of 72 channels
    ((1, 1, 65, 40), torch.float32),        # H = 1; one column past the tile; C = 40
    ((2, 6, 17, 37), torch.float32),        # C % 4 != 0: element staging and stores; W = 17
    ((1, 17, 40, 36), torch.float32, 2),    # inputs off 16-byte alignment; H = 17
    ((1, 9, 64, 64), torch.float32, 0, 1),  # g alone off 16-byte alignment
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
# where it is not 0); its patch is ops/correlation.py's KERNEL_PATCH. bf16
# runs corr_band.cuh's tensor-core band tile (64-column tiles, 64-channel
# boxes of 16-channel mma steps; corr2d two rows a block); fp32 corr1d
# corr_tile.cuh's corr1d_fp32_kernel (64-column row tiles, a cp.async ring of
# 32-channel stages), fp32 corr2d corr2d.cu's own FFMA kernel (4 rows a
# block).
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
        *OVERFIT_TRAIN_CASES,                # phase 15: sdnet_mini's 1/8 map at the tool's
        ((1, 12, 20, 352), torch.float32),   # 64x128 crops and its 96x160 eval rows (one a
        ((1, 12, 20, 352), torch.bfloat16),  # forward): W 16 and 20, under one 64-column tile
        # the fp32 kernel's edges: 64-column row tiles, 32-channel stages in a
        # ring of 4, cp.async copies or (C % 4 != 0, misaligned) element loads
        ((1, 2, 16, 8), torch.float32),      # C below one stage; W < 17
        ((1, 1, 17, 352), torch.float32),    # H = 1, W = 17; 11 stages: the ring wraps
        ((1, 3, 65, 136), torch.float32),    # W = 65: a last tile of one column; a last
                                             # stage of 8 channels
        ((2, 3, 33, 37), torch.float32, 1),  # C % 4 != 0 and misaligned: element loads
        ((2, 3, 70, 352), torch.float32, 1),  # C % 4 == 0, misaligned: element loads
        ((1, 2, 120, 1024), torch.float32),  # C = 1024: 32 stages; tiles of 64 and 56 columns
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
        # the fp32 kernel's edges: 4-row blocks in 2 passes of 10 f2 rows,
        # 8-channel stages of 16-byte copies, 64-column tiles
        ((1, 3, 70, 352), torch.float32),    # H < 4: one block, rows cut by H
        ((2, 6, 65, 40), torch.float32),     # H = 6: blocks of 4 and 2 rows; W = 65; C = 40: a
                                             # last stage of 4 channels
        ((1, 1, 17, 36), torch.float32),     # H = 1, W = 17
        ((1, 21, 64, 8), torch.float32),     # 6 blocks, every f2 row of both passes; one stage
        ((1, 9, 130, 37), torch.float32),    # C % 4 != 0: element staging; W = 130
        ((1, 7, 40, 36), torch.float32, 1),  # inputs off 16-byte alignment: element staging
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

# phase 12: EncoderDecoderNet at the reference's full width (resnet50
# encoder, num_filters 16, 19 labels) with each decoder type. The SCSE and
# SE-IBN nets serve the bench's 16x512x960 and train its 8x256x512. The OC
# net's attention is dense over (HW, HW) at every decoder scale: dec1's, at
# /2 of 512x960, would hold 122,880^2 fp32 logits, 60.4 GB a sample. So it
# serves 4x256x512 and trains 2x256x512: 32,768 tokens, 4.29 GB a sample for
# a copy of the logits, two copies at the softmax (and in training a third,
# their gradient), PERF.md §4
ENCDEC = {"labels": 19, "enc_type": "resnet50", "num_filters": 16}
ENCDEC_SERVE = {"unet_scse": (BATCH, H, W), "unet_seibn": (BATCH, H, W), "unet_oc": (4, 256, 512)}
ENCDEC_TRAIN = {"unet_scse": (TRAIN_BATCH, TRAIN_H, TRAIN_W),
                "unet_seibn": (TRAIN_BATCH, TRAIN_H, TRAIN_W), "unet_oc": (2, 256, 512)}
ENCDEC_SERVE_BATCHES = 3  # a warm-up and two timed batches
ENCDEC_TRAIN_STEPS = 2    # the first with cuDNN's first calls, the second timed
ENCDEC_SMALL = (1, 64, 128, 3)  # card vs CPU, fp32
# phase 12: the flagship's banded forward (parallel/spatial.py): 8 bands of
# 64 rows with a 64-row halo each side, stacked on the batch axis; card vs
# CPU at a small size (2 bands of 64 rows, a 32-row halo); the seam rows
# read are those within SEAM_ROWS of a boundary between two bands
BANDED_SHAPE, BANDS, HALO = (2, H, W), 8, 64
BANDED_SMALL, SMALL_BANDS, SMALL_HALO = (1, 128, 128), 2, 32
SEAM_ROWS = 4
# phase 13: data parallel over torch.distributed (parallel/mesh.py). The
# default run spawns DDP_RANKS ranks over gloo, all on the one card (NCCL
# refuses two ranks on one card); --ddp spawns one rank a card over NCCL
DDP_RANKS = 2
DDP_SMALL = (64, 128)  # (a): one pair a rank, fp32, against one process on every rank's pairs
DDP_PAIRS = 4          # (b): pairs a rank of the timed bf16 step (8x256x512 on two ranks)
DDP_WARMUP, DDP_STEPS = 2, 4
DDP_FILES = FILES_TRAIN + ["-e", "1"]  # (c): phase 8's run for one epoch (the last -e counts)
DDP_SCALE_CARDS = (1, 2, 4)  # --ddp: the bf16 step at TRAIN_BATCH pairs a card on 1, 2 and 4 cards
DDP_SCALE_STEPS = 6          # timed, after DDP_WARMUP
DDP_TRACE_STEPS = 2          # --ddp: steps traced (utils/profiling.py:trace) on each mesh's rank 0
DDP_TIMEOUT_S = 900
# phase 14: the CLI's default precision (no -f16): sdnet in fp32 at full width
# and depth, serving BATCH pairs of HxW (a warm-up and FP32_SERVE_BATCHES - 1
# timed batches) and training at TRAIN_BATCH pairs of 256x512 (TRAIN_WARMUP
# and FP32_TRAIN_STEPS timed steps), with cuDNN's TF32 as the program leaves
# it; then the CLI on phase 8's files, one epoch of 2 steps and its eval
FP32_SERVE_BATCHES = 4
FP32_TRAIN_STEPS = 8
FP32_FILES = ("-net sdnet -backbone densenet -corrType 2dcorr -crop 256 512 -b 8 -e 1 "
              "-loss cross_entropy lovasz_loss tversky_loss ohm_loss -output_activation linear "
              "-datasetName roses -train 1 -show_results 0").split()
# phase 15: the port's learning gate (tools/overfit_smoke.py: sdnet_mini on
# the tool's fixture of 8 training pairs of 96x160, evaluated on the same
# pairs, 64x128 crops, batches of 8, Adam at 5e-3, OVERFIT_EPOCHS epochs of
# one step) at full width and depth, each run a Session of its own from the
# seeded init: sdnet_mini in fp32 and under the bf16 policy at each of
# OVERFIT_SEEDS (cfg.run.seed; the fixture's own seed stays 0), and the
# flagship at scripts/train_flagship.sh's flags (overfit_smoke.FLAGSHIP) in
# fp32 at seed 0, with TF32 as the program leaves it; then the negative
# control, sdnet_mini fp32 at seed 0 with its labels rolled along each
# training batch (overfit_smoke.LabelFault)
OVERFIT_EPOCHS = 40
OVERFIT_SEEDS = (0, 1, 2)
OVERFIT_STEPS_PER_EPOCH = 1  # the tool's 8 training pairs in batches of 8
OVERFIT_EVAL_ROWS = 8        # the same 8 pairs, evaluated once, after the last epoch
# sdnet_mini and the flagship correlate with corr1d: its forward once a
# train step and once an eval row (the eval step runs each row alone), its
# backward once a train step, corr2d never
OVERFIT_LAUNCHES = {"corr1d": OVERFIT_EPOCHS * OVERFIT_STEPS_PER_EPOCH + OVERFIT_EVAL_ROWS,
                    "corr1d_backward": OVERFIT_EPOCHS * OVERFIT_STEPS_PER_EPOCH,
                    "corr2d": 0, "corr2d_backward": 0}
# a run learns: its last epoch's train loss at most this share of its first's
OVERFIT_LOSS_DROP = 0.5
# the held readout: mIoU(head 2) on the 8 pairs with BatchNorm on their own
# statistics (overfit_smoke.batch_statistics_miou) at OVERFIT_EPOCHS, at
# least this in every run that learns and below it in the control. Halfway
# between the card's readings of both (PERF.md section 6, the overfit gate:
# tools/overfit_curve.py at 40 epochs): the sound runs' worst 0.6524 (25
# runs: sdnet_mini fp32 and bf16 at seeds 0-9, the flagship at 0-4), the
# label fault's best 0.4675 (15 runs: each configuration at seeds 0-4)
OVERFIT_HELD_MIOU = 0.56
# the JAX package's readings of the tool's mIoU(head 2) at 40 epochs on a CPU
# of 8 cores, at the seeds phase 15 runs (PERF.md section 6, the overfit gate:
# `JAX_PLATFORMS=cpu python tests/jax_overfit_curve.py`, the JAX tool's own
# configuration). Printed beside the port's, not held: at 40 epochs the
# tool's eval swings between neighbouring epochs in both packages
OVERFIT_JAX_CPU = {"sdnet_mini fp32": (0.3497, 0.5179, 0.9376), "sdnet_mini bf16": (0.2940, 0.9675, 0.3756),
                   "flagship fp32": (0.3182,)}
# phase 16: the repository's launch scripts in the port
# (pmt_..._torch/scripts/train_flagship.sh and eval_flagship.sh: the root
# scripts with the port's CLI module), run unmodified by bash from a working
# directory of their own: the flagship (densenet121, 1dcorr) in the CLI's
# default fp32, 256x512 crops, batches of 8, 100 epochs, CE + Lovász, Adam,
# an eval every 10 epochs (the config's eval_every), then the eval script at
# -b 1 -show_results 1 on the checkpoint. The fixture: 8 training pairs (an
# epoch is one step), 2 val and 2 test pairs of 256x512, the scripts' crop
# (the eval pads them into the 512x960 bucket), in the scripts' manifests
# with absolute paths; `small` reads reduced_size/*__small.txt, which the
# root scripts/reduce_existent_dataset.py writes in the dataset directory
SCRIPTS = f"{PORT}/scripts"
SCRIPTS_HW = (256, 512)
SCRIPTS_TRAIN_PAIRS, SCRIPTS_VAL_PAIRS, SCRIPTS_TEST_PAIRS = 8, 2, 2
SCRIPTS_EPOCHS, SCRIPTS_EVAL_EVERY = 100, 10  # train_flagship.sh's -e 100; the config's eval_every
SCRIPTS_STEPS = SCRIPTS_EPOCHS * SCRIPTS_TRAIN_PAIRS // TRAIN_BATCH
SCRIPTS_TRAIN_EVAL_ROWS = SCRIPTS_EPOCHS // SCRIPTS_EVAL_EVERY * SCRIPTS_VAL_PAIRS
# corr1d's fp32 forward at this path's shapes: a view's 1/8 map in a train
# step, and an eval row's in the 512x960 bucket (the eval step runs each row
# alone)
SCRIPTS_CORR_SHAPES = {k: FP32_CORR1D_SHAPES[k] for k in ("training step", "eval row")}
SCRIPTS_TIMEOUT_S = 600  # each script's run


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


def zero_counts() -> dict:
    """Every kernel's count set to 0; returns the wrappers (``counters``)."""
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    return kernels


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
        elif dtype == torch.float32:  # the CLI's default precision
            record["fp32"] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                              "max_abs_err": err, "share_of_bound": bound_ms / ms}
        else:  # bf16, the serving path's dtype
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
        f1, f2 = (inputs(shape, dtype, g, *offset[:1]) for _ in range(2))
        grad = inputs(tuple(shape[:3]) + (patch[0] * patch[1],), dtype, g, *offset[-1:])
        got = kernel(f1, f2, grad)
        torch.cuda.synchronize()
        where = (f" at element offset {offset[0]}" if offset else "") + (
            f", g at {offset[1]}" if len(offset) > 1 else "")
        what = f"[{name} backward] {tuple(shape)} {str(dtype)[6:]}{where}"
        errs = hold(got, plain(f1, f2, grad), what, f1.shape, dtype)
        if name == "corr2d":  # one owner for each output element: a second launch is bit-equal
            again = kernel(f1, f2, grad)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what}: two launches differ")
            del again
        if any(offset) or shape not in (TRAIN_SHAPE, CORR_SHAPE, ASPP2_SERVE_SHAPE, ASPP2_TRAIN_SHAPE):
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
        if dtype == torch.float32 and shape in (TRAIN_SHAPE, CORR_SHAPE):  # the CLI's precision
            record.setdefault("fp32", []).append(
                {"shape": list(shape), "ms": ms, "ms_warm": warm_ms, "median_ms": median_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "max_abs_err": max(errs), "share_of_bound": bound_ms / ms})
        elif shape in (ASPP2_SERVE_SHAPE, ASPP2_TRAIN_SHAPE):  # aspp 2's site
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
    flushed; corr1d's fp32 forward and backward at every case the same way
    (the forward alone and warm, the backward flushed). Returns one record a
    case."""
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
        elif name == "corr1d":  # the CLI's default precision: corr1d_fp32_kernel and the fp32 backward
            nbytes = (f1.numel() + f2.numel() + f1.numel() // shape[-1] * patch[1]) * 4
            ops = 2 * f1.numel() * patch[1]
            rec["bound_ms"], rec["bound_by"] = byte_bound_ms(nbytes, ops, dtype)
            rec["ms"], rec["ms_median"] = event_time_ms(lambda: fn(f1, f2, arg), 30, flush=False)
            bbytes = (4 * f1.numel() + grad.numel()) * 4
            rec["backward_bound_ms"], _ = byte_bound_ms(bbytes, 2 * ops, dtype)
            rec["backward_ms_flushed"], rec["backward_ms_flushed_median"] = event_time_ms(
                lambda: bwd(f1, f2, grad), 20, flush=True)
            print(f"{tag}: {rec['ms']:.4f} ms a launch alone (median {rec['ms_median']:.4f}; bound "
                  f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, {rec['bound_ms'] / rec['ms']:.1%}); backward "
                  f"{rec['backward_ms_flushed']:.4f} ms flushed (median {rec['backward_ms_flushed_median']:.4f}; "
                  f"bound {rec['backward_bound_ms']:.4f}, {rec['backward_bound_ms'] / rec['backward_ms_flushed']:.1%})",
                  flush=True)
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
                losses=TRAIN_LOSSES, dataset: str = "roses", mesh=None, sync_bn: bool = True):
    """The net of the run (``RUNS``), its Adam train state and its train step
    on ``device`` (the same weights from seed 0 on every device). With a
    ``mesh`` (phase 13), the step of one rank: BatchNorm cross-replica over
    the mesh's data group where ``sync_bn``, the state rank 0's."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import replicate
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
    if mesh is not None and sync_bn:
        models.set_batch_norm_group(model, mesh.data_group)
    state = TrainState.create(model, build_optimizer(cfg.optim, cfg.model.net, len(losses)))
    if mesh is not None:
        replicate(mesh, state)
    return model, state, make_train_step(cfg, model, device=device, mesh=mesh)


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


def hold_loss(tag: str, loss: float, ref: float, names=("card", "CPU")) -> None:
    err = abs(loss - ref)
    print(f"{tag} loss {names[0]} {loss:.8g} {names[1]} {ref:.8g}: |d| = {err:.6g} "
          f"(tolerance {1e-3 * abs(ref):.6g} = 1e-3 * |ref|)", flush=True)
    check(err <= 1e-3 * abs(ref), f"{tag}: loss {loss} against {ref}")


def worst_tensor(got: dict, ref: dict):
    """(max|d| / max|ref|, name) of the tensor of ``got`` farthest from
    ``ref``'s, relative to its own largest reference value."""
    return max(((got[n] - r).abs().max().item() / (r.abs().max().item() or float("inf")), n)
               for n, r in ref.items())


def hold_tensors(tag: str, what: str, got: dict, ref: dict, ref_name: str = "the CPU's") -> None:
    """Every tensor of ``got`` within 1e-3 * max|ref| of ``ref``'s."""
    check(set(got) == set(ref), f"{tag}: {what} of other names")
    for n, r in ref.items():
        err, bound = (got[n] - r).abs().max().item(), 1e-3 * r.abs().max().item()
        check(err <= bound, f"{tag}: {what} {n}: max|d| {err} > {bound}")
    rel, name = worst_tensor(got, ref)
    print(f"{tag} every {what} tensor ({len(ref)}) within 1e-3 * max|ref| of {ref_name}; the "
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


def phase_train(net: str, n_warmup: int, n_steps: int, card: str, bf16: bool = True):
    """Train ``net`` at full width (bf16 policy, or fp32 where not ``bf16``;
    the bench loss stack, Adam); returns each kernel's launches in the timed
    steps, the counts set to 0 just before them."""
    kernels = counters()
    expect = TRAIN[net]
    _, state, step = train_setup(net, "cuda", bf16=bf16)
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
            zero_counts()
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
    print(f"[train {net}] {trunk_name(run_config(net))} {'bf16' if bf16 else 'fp32'}, CE + Lovasz + "
          f"MultiTversky + OHEM, Adam, "
          f"{TRAIN_BATCH} pairs of {TRAIN_H}x{TRAIN_W}: {ms:.2f} ms/step, "
          f"{TRAIN_BATCH / ms * 1e3:.2f} training pairs/s over {len(timed)} steps (per step: "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times)} ms, the first {n_warmup} warm-ups); "
          f"losses {', '.join(f'{v:.5g}' for v in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {card}",
          flush=True)
    return launches


def phase_serve(net: str, n_batches: int, expect: dict, bf16: bool = True):
    """Serve ``n_batches`` batches (the first a warm-up, not timed) under the
    bf16 policy, or in fp32 where not ``bf16``, and check each kernel's
    launches against ``expect`` (name -> launches per batch)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
        compute_metrics,
        make_forward_fn,
    )

    cfg = run_config(net, bf16=bf16)
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
    zero_counts()
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
    print(f"[serve {net}] {trunk_name(cfg)} {'bf16' if bf16 else 'fp32'}, {BATCH} pairs of {H}x{W}: "
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

    zero_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        session = cli.main(argv)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    text = out.getvalue()
    print(text, end="", flush=True)
    return session, text, launches


def hold_cli_launches(tag: str, session, launches: dict, sites: int = 1,
                      corr: str = "corr1d") -> None:
    """The net's correlation ``corr`` (corr1d, or corr2d: sdnet): its forward
    once a train step and once an eval forward (one a reported row: the eval
    step runs each row alone and skips the padded tail), its backward once a
    train step, the other correlation's kernels never; each ``sites`` times
    (2 at aspp 2)."""
    t = session.timings
    steps = len(t["step_s"])
    forwards = t["eval_rows"]
    other = "corr2d" if corr == "corr1d" else "corr1d"
    expect = {corr: sites * (steps + forwards), f"{corr}_backward": sites * steps, other: 0,
              f"{other}_backward": 0}
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


def eval_table(rows: list, summary: dict) -> dict:
    """An eval's pooled summary with the mean and std of each column of its
    per-row table."""
    table = dict(summary)
    for k in rows[0]:
        table[f"{k} mean"] = float(np.mean([r[k] for r in rows]))
        table[f"{k} std"] = float(np.std([r[k] for r in rows]))
    return table


def hold_eval_tables(tag: str, a: dict, b: dict) -> None:
    """Every value of two eval tables (``eval_table``) within
    ``FILES_EVAL_RTOL`` relative."""
    check(set(a) == set(b), f"{tag}: eval summaries of other keys")
    rel = {k: abs(a[k] - b[k]) / max(abs(a[k]), abs(b[k]), 1e-12) for k in a}
    worst = max(rel, key=rel.get)
    print(f"{tag}: the farthest of {len(rel)} summary values {worst} at {rel[worst]:.3g} relative "
          f"(tolerance {FILES_EVAL_RTOL:g})", flush=True)
    check(rel[worst] <= FILES_EVAL_RTOL, f"{tag}: eval summaries differ: {worst} {a[worst]} vs {b[worst]}")


def files_fixture(root: str) -> list:
    """Phase 8's files: a roses fixture of FILES_TRAIN_PAIRS training and
    FILES_TEST_PAIRS test pairs of FILES_HW under ``root``, made by the port's
    own ``make_roses_fixture``; returns the CLI's data flags."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import make_roses_fixture

    m = make_roses_fixture(root, n_train=FILES_TRAIN_PAIRS, n_test=FILES_TEST_PAIRS, hw=FILES_HW,
                           seed=0)
    data = []
    for flag, key in (("-colorL", "left"), ("-colorR", "right"), ("-seg", "seg"), ("-disp", "disp"),
                      ("-inst", "inst")):
        data += [flag, m[key], flag + "_test", m[key + "_t"]]
    return data


def phase_files(card: str):
    """Phase 8: the flagship trained, resumed and evaluated from PNG files
    through the CLI; returns each kernel's launches in the first training
    run (its 4 train steps and its eval)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config_from_args
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import datasets, native, png
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session

    correlation = correlation_module()
    kernels = {"corr1d": correlation.correlation1d_cuda,
               "corr1d_backward": correlation.correlation1d_backward_cuda,
               "corr2d": correlation.correlation2d_cuda,
               "corr2d_backward": correlation.correlation2d_backward_cuda}
    tmp = tempfile.mkdtemp(prefix="pmt_files_")
    try:
        t0 = time.perf_counter()
        data = files_fixture(os.path.join(tmp, "ds"))
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
            # at -show_results 1, the flag's default: the summary is printed and
            # both confusion heatmaps are written to ./testResults, without
            # matplotlib (the card's machine has none)
            cwd = os.path.join(tmp, f"eval_b{b}")
            os.makedirs(cwd)
            with contextlib.chdir(cwd):
                ev, text, launches = cli_run(data + FILES_TRAIN + [
                    "-train", "0", "-b", str(b), "-load_weights", ckpt, "-show_results", "1"], kernels)
            check(text.strip().splitlines()[-1] == str(ev.eval_summary),
                  f"eval -b {b} -show_results 1: the summary is not the last line printed")
            for head in (1, 2):
                heatmap = png.read(os.path.join(cwd, "testResults", f"confusion_head{head}.png"))
                check(heatmap.shape[2] == 3 and heatmap.shape[0] == heatmap.shape[1] > 0,
                      f"eval -b {b}: confusion_head{head}.png decodes to {heatmap.shape}")
            print(f"[files eval -b {b}] -show_results 1: summary printed; confusion_head1.png and "
                  f"confusion_head2.png decode to {heatmap.shape}; "
                  f"{len(os.listdir(os.path.join(cwd, 'testResults')))} files in testResults",
                  flush=True)
            t = ev.timings
            hold_cli_launches(f"[files eval -b {b}]", ev, launches)
            check(t["eval_rows"] == FILES_TEST_PAIRS, f"eval -b {b}: {t}")
            summaries[b] = eval_table(ev.accumulator.rows, ev.eval_summary)
            print(f"[files eval -b {b}] {t['eval_batches']} batches: {t['eval_rows'] / t['eval_s']:.2f} "
                  f"pairs/s (host, loading and -show_results 1's files included); launches {launches}; "
                  f"{card}", flush=True)
            del ev
        hold_eval_tables(f"[files eval] -b {FILES_EVAL_BATCHES[0]} vs -b {FILES_EVAL_BATCHES[1]}",
                         *(summaries[k] for k in FILES_EVAL_BATCHES))
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
    kernels = zero_counts()
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
        zero_counts()
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


def encdec_model(dec_type: str, device: str, seed: int = 0):
    """Phase 12's EncoderDecoderNet (``ENCDEC``) with the seeded init drawn on
    the host and the attention's zero-initialised ``W`` given seeded values
    (at zero the ObjectContext path would add exactly nothing), moved to
    ``device`` in eval mode: the same weights on every device."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models

    model = models.init_parameters(models.EncoderDecoderNet(dec_type=dec_type, **ENCDEC),
                                   torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 2)[-2] == "W":
                scale = 1.0 / p[0].numel() ** 0.5 if p.dim() > 1 else 0.1
                p.copy_(scale * torch.randn(p.shape, generator=g))
    return model.to(device).eval()


def encdec_config(net: str = "sdnet_mini_ext"):
    """A bf16 config of the cityscapes layout (19 classes and the ignore
    channel). With the default net, ``make_forward_fn`` takes its plain path
    (no pre- or post-processing, no keyword inputs), which is the one
    EncoderDecoderNet needs; with ``deeplab``, ``make_losses_fn`` gives the
    seg-only loss the mono deeplab net trains with (head 1's cross entropy;
    its disparity head is the ground truth)."""
    cfg = config(net, bf16=True)
    cfg.data.dataset_name = "cityscapes"
    return cfg


def hold_no_launches(tag: str, kernels: dict) -> dict:
    """EncoderDecoderNet correlates nothing: every kernel's count is 0."""
    launches = {name: k.launches for name, k in kernels.items()}
    check(not any(launches.values()), f"{tag}: launches {launches}, expected none")
    return launches


def phase_encdec_forward(dec_type: str) -> None:
    """The fp32 eval forward card vs CPU at ``ENCDEC_SMALL``, within
    1e-3 * max|ref|."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(ENCDEC_SMALL, generator=g)
    with torch.inference_mode():
        ref = encdec_model(dec_type, "cpu")(x)["seg1"]
        kernels = zero_counts()
        got = encdec_model(dec_type, "cuda")(x.cuda())["seg1"].cpu()
        hold_no_launches(f"[encdec {dec_type}] card forward", kernels)
    err, bound = (got - ref).abs().max().item(), 1e-3 * ref.abs().max().item()
    print(f"[encdec {dec_type}] {ENCDEC['enc_type']}, num_filters {ENCDEC['num_filters']}, "
          f"{ENCDEC['labels']} labels, 1x64x128 fp32 forward: card "
          f"vs CPU max|d| = {err:.6g} (tolerance {bound:.6g} = 1e-3 * max|ref|)", flush=True)
    check(tuple(got.shape) == (1, 64, 128, 19) and err <= bound,
          f"[encdec {dec_type}] card forward {tuple(got.shape)}: {err} > {bound}")


def phase_encdec_serve(dec_type: str, card: str) -> dict:
    """Serve ``ENCDEC_SERVE_BATCHES`` batches of ``ENCDEC_SERVE`` under the
    bf16 policy through ``make_forward_fn`` (the first a warm-up): seg1 of
    19 classes, finite, the other heads None; no kernel launched."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_forward_fn

    b, h, w = ENCDEC_SERVE[dec_type]
    forward = make_forward_fn(encdec_config(), encdec_model(dec_type, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(12)
    batches = [{"left": torch.randn((b, h, w, 3), device="cuda", generator=g),
                "right": torch.randn((b, h, w, 3), device="cuda", generator=g)}
               for _ in range(ENCDEC_SERVE_BATCHES)]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = zero_counts()
    times = []
    with torch.inference_mode():
        for batch in batches:
            t0 = time.perf_counter()
            out = forward(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            seg = out["seg1"]
            check(tuple(seg.shape) == (b, h, w, ENCDEC["labels"]) and seg.dtype == torch.float32
                  and bool(torch.isfinite(seg).all()) and out["seg2"] is None and out["disp1"] is None,
                  f"[encdec {dec_type} serve] seg1 {tuple(seg.shape)} {seg.dtype}")
    launches = hold_no_launches(f"[encdec {dec_type} serve]", kernels)
    ms = 1e3 * sum(times[1:]) / len(times[1:])
    print(f"[encdec {dec_type} serve] {ENCDEC['enc_type']} bf16, {b} images of {h}x{w}: "
          f"{ms:.2f} ms/batch, "
          f"{b / ms * 1e3:.2f} pairs/s over {len(times) - 1} batches (per batch: "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times)} ms, the first a warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {card}",
          flush=True)
    del forward, batches, out
    return launches


def phase_encdec_train(dec_type: str, card: str) -> dict:
    """``ENCDEC_TRAIN_STEPS`` bf16 train steps at ``ENCDEC_TRAIN`` (train-mode
    forward through ``make_forward_fn``, the seg-only loss of
    ``make_losses_fn`` for the mono deeplab net's output type on cityscapes
    ground truth, backward, Adam): finite losses and gradients; no kernel
    launched."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
        TrainState,
        build_optimizer,
        make_forward_fn,
        make_losses_fn,
    )

    model = encdec_model(dec_type, "cuda")
    cfg = encdec_config()
    forward, losses = make_forward_fn(cfg, model), make_losses_fn(encdec_config("deeplab"))
    state = TrainState.create(model, build_optimizer(cfg.optim, "deeplab", 1))
    g = torch.Generator(device="cuda").manual_seed(13)
    shape = ENCDEC_TRAIN[dec_type]
    batches = [train_batch(shape, g, "cuda", "cityscapes") for _ in range(ENCDEC_TRAIN_STEPS)]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = zero_counts()
    times, values = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state.optimizer.zero_grad()
        out = forward(batch, True)
        # the mono deeplab net's heads: seg2 mirrors seg1, disparity is the ground truth
        out = dict(out, seg2=out["seg1"], disp1=batch["disp"], disp2=batch["disp"])
        loss, _ = losses(out, batch)
        loss.backward()
        state.apply_gradients()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        values.append(loss.item())
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        check(bool(torch.isfinite(loss)) and len(grads) == len(list(model.parameters()))
              and all(bool(torch.isfinite(t).all()) for t in grads),
              f"[encdec {dec_type} train] a loss or gradient is not finite: {loss.item()}")
    launches = hold_no_launches(f"[encdec {dec_type} train]", kernels)
    b, h, w = shape
    print(f"[encdec {dec_type} train] {ENCDEC['enc_type']} bf16, cross entropy on cityscapes "
          f"labels, Adam, {b} "
          f"images of {h}x{w}: losses {', '.join(f'{v:.5g}' for v in values)}, {len(grads)} finite "
          f"gradient tensors; per step {', '.join(f'{1e3 * t:.2f}' for t in times)} ms (the first "
          f"with cuDNN's first calls), {b / times[-1]:.2f} training pairs/s at the last; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {card}",
          flush=True)
    del model, state, forward, batches, out, loss, grads
    return launches


def phase_encdec_restore(dec_type: str, tmp: str) -> None:
    """A reference-layout state dict of a seeded model (``export_state_dict``
    of ``encdec_entries``), saved as a ``.pth.tar`` and read back, imports
    through ``import_encdec`` into a model of other weights: every tensor
    and the bf16 outputs on the card bit-equal to the source's."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_forward_fn
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import as ti

    source = encdec_model(dec_type, "cpu", seed=3)
    path = os.path.join(tmp, f"encdec_{dec_type}.pth.tar")
    torch.save({"state_dict": ti.export_state_dict(source, ti.encdec_entries(source))}, path)
    state = ti.load_torch_state_dict(path)
    fresh = encdec_model(dec_type, "cpu", seed=4)
    ti.load_port_state(fresh, ti.import_encdec(state, fresh))
    want = source.state_dict()
    for k, v in fresh.state_dict().items():
        check(torch.equal(v, want[k]), f"[encdec {dec_type} restore] {k} differs")
    g = torch.Generator(device="cuda").manual_seed(14)
    batch = {"left": torch.randn((2, 128, 256, 3), device="cuda", generator=g)}
    batch["right"] = batch["left"]
    with torch.inference_mode():
        a = make_forward_fn(encdec_config(), source.cuda())(batch)["seg1"]
        b = make_forward_fn(encdec_config(), fresh.cuda())(batch)["seg1"]
    check(torch.equal(a, b), f"[encdec {dec_type} restore] bf16 outputs differ")
    print(f"[encdec {dec_type} restore] {len(state)} reference keys through import_encdec: "
          f"all {len(want)} tensors and the bf16 outputs at 2x128x256 bit-equal", flush=True)


def phase_banded_placement() -> None:
    """Control: at ``BANDED_SHAPE`` in fp32 (TF32 off), the banded forward
    equals each band's own forward with its interior rows put in place by
    hand, within 1e-3 * max|ref|: stacking the bands on the batch axis and
    ``merge_bands`` change nothing, so what parts the banded forward from
    the monolithic one is what each band sees."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import (
        spatial_shard_infer,
        split_bands,
    )

    model = models.get_network(config("sdnet_mini_ext"), device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(17)
    left, right = (torch.randn(BANDED_SHAPE + (3,), device="cuda", generator=g) for _ in range(2))
    b, bh = BANDED_SHAPE[0], H // BANDS
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            got = spatial_shard_infer(model, left, right, BANDS, HALO)
            lb, _, _ = split_bands(left, BANDS, HALO)
            rb, _, _ = split_bands(right, BANDS, HALO)
            want = {k: torch.empty_like(v) for k, v in got.items()}
            for i in range(BANDS):
                alone = model(lb[i * b:(i + 1) * b], rb[i * b:(i + 1) * b])
                for k in want:
                    want[k][:, i * bh:(i + 1) * bh] = alone[k][:, HALO:HALO + bh]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    worst = []
    for k in want:
        err, bound = (got[k] - want[k]).abs().max().item(), 1e-3 * want[k].abs().max().item()
        check(err <= bound, f"[banded] placement {k}: max|d| {err} > {bound}")
        worst.append(f"{k} {err:.4g} ({err / bound:.3g} of its bound)")
    print(f"[banded] control, fp32 without TF32: the banded forward against each band's own "
          f"forward put in place by hand, max|d| {'; '.join(worst)}", flush=True)


def phase_banded(card: str) -> dict:
    """``parallel/spatial.py`` on the flagship: the fp32 banded forward card
    vs CPU at ``BANDED_SMALL`` within 1e-3 * max|ref|; then under the bf16
    policy at ``BANDED_SHAPE`` the banded forward (``BANDS`` bands, ``HALO``
    rows each side, one batch) against the monolithic one, max|d| over the
    rows beside the image's top and bottom, over the seams and over the
    rest, a reading, not a bound; the same reading for one band (the halo's
    zero rows alone) and for a halo of the image's height; the controls
    (one band without a halo; ``phase_banded_placement``). corr1d once a
    forward, banded or not. Returns the banded forward's launches."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import (
        spatial_shard_infer,
    )
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_forward_fn

    heads = ("seg1", "seg2", "disp1", "disp2")
    cfg = config("sdnet_mini_ext")
    g = torch.Generator().manual_seed(15)
    left, right = (torch.randn(BANDED_SMALL + (3,), generator=g) for _ in range(2))
    outs = {}
    with torch.inference_mode():
        for device in ("cpu", "cuda"):
            model = models.get_network(cfg, device=device, seed=0)
            outs[device] = spatial_shard_infer(model, left.to(device), right.to(device),
                                               SMALL_BANDS, SMALL_HALO)
    worst = []
    for k in heads:
        ref, got = outs["cpu"][k], outs["cuda"][k].cpu()
        err, bound = (got - ref).abs().max().item(), 1e-3 * ref.abs().max().item()
        check(got.shape == ref.shape and err <= bound, f"[banded] small {k}: {err} > {bound}")
        worst.append((err / bound, k))
    print(f"[banded] flagship fp32, {'x'.join(map(str, BANDED_SMALL))} in {SMALL_BANDS} bands with a "
          f"{SMALL_HALO}-row halo: card vs CPU within 1e-3 * max|ref|, the closest {max(worst)[1]} at "
          f"{max(worst)[0]:.3g} of its bound", flush=True)

    cfg = config("sdnet_mini_ext", bf16=True)
    forward = make_forward_fn(cfg, models.get_network(cfg, seed=0))

    def apply(l, r):
        return forward({"left": l, "right": r})

    g = torch.Generator(device="cuda").manual_seed(16)
    left, right = (torch.randn(BANDED_SHAPE + (3,), device="cuda", generator=g) for _ in range(2))
    kernels = counters()
    with torch.inference_mode():
        times = {}
        for name, fn in (("monolithic", lambda: apply(left, right)),
                         ("banded", lambda: spatial_shard_infer(apply, left, right, BANDS, HALO))):
            fn()  # a warm-up at the shape: cuDNN's first calls
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = fn()
            torch.cuda.synchronize()
            times[name] = 1e3 * (time.perf_counter() - t0)
            launches = {n: k.launches for n, k in kernels.items()}
            check(launches == {"corr1d": 1, "corr1d_backward": 0, "corr2d": 0, "corr2d_backward": 0},
                  f"[banded] {name} forward launches {launches}")
        # the same image as one band with the halo's zero rows above and below
        # it, and in BANDS bands whose halo spans the whole image
        outs["one band"] = spatial_shard_infer(apply, left, right, 1, HALO)
        outs["whole-image halo"] = spatial_shard_infer(apply, left, right, BANDS, H)
        # control: one band without a halo is the monolithic forward
        one = spatial_shard_infer(apply, left, right, 1, 0)
    control = []
    for k in heads:
        err, bound = ((one[k] - outs["monolithic"][k]).abs().max().item(),
                      1e-3 * outs["monolithic"][k].abs().max().item())
        check(err <= bound, f"[banded] one band, no halo: {k} max|d| {err} > {bound}")
        control.append(f"{k} {err:.4g}")
    bh = H // BANDS
    row = torch.arange(H, device="cuda")
    edge = (row < HALO) | (row >= H - HALO)  # beside the zero rows split_bands adds
    seam = ((row % bh < SEAM_ROWS) | (row % bh >= bh - SEAM_ROWS)) & ~edge
    rest = ~edge & ~seam

    def regions(name, k):
        d = (outs[name][k] - outs["monolithic"][k]).abs().amax(dim=(0, 2, 3))  # per row
        return " / ".join(f"{d[m].max().item():.4g}" for m in (edge, seam, rest))

    readings = {name: [] for name in ("banded", "one band", "whole-image halo")}
    for k in heads:
        scale = outs["monolithic"][k].abs().max().item()
        for name in readings:
            readings[name].append(f"{k} {regions(name, k)} (max|ref| {scale:.4g})")
        check(bool(torch.isfinite(outs["banded"][k]).all()), f"[banded] {k} is not finite")
    print(f"[banded] flagship bf16, {'x'.join(map(str, BANDED_SHAPE))} in {BANDS} bands of {bh} rows "
          f"with a {HALO}-row halo ({BANDED_SHAPE[0] * BANDS} bands of {bh + 2 * HALO}x{W} in one "
          f"batch) against the monolithic forward, max|d| over the rows within {HALO} of the "
          f"image's top or bottom / the other rows within {SEAM_ROWS} of a band boundary / the "
          f"rest: {'; '.join(readings['banded'])}; {times['monolithic']:.2f} ms monolithic, "
          f"{times['banded']:.2f} ms banded (host clock, one forward each after a warm-up); "
          f"launches {launches}; {card}", flush=True)
    print(f"[banded] the same regions, one band with {HALO} zero rows above and below the image: "
          f"{'; '.join(readings['one band'])}", flush=True)
    print(f"[banded] the same regions, {BANDS} bands with a {H}-row halo (each band sees the whole "
          f"image): {'; '.join(readings['whole-image halo'])}", flush=True)
    print(f"[banded] control: one band without a halo against the monolithic forward, max|d| "
          f"{'; '.join(control)} (tolerance 1e-3 * max|ref|)", flush=True)
    phase_banded_placement()
    return launches


def phase_encdec(card: str) -> dict:
    """Phase 12: EncoderDecoderNet at full width with each decoder type
    (card vs CPU, serving, training, the importer's restore; no kernel
    launched on any of its paths), then the flagship's banded forward.
    Returns {path: launches}."""
    paths = {}
    tmp = tempfile.mkdtemp(prefix="pmt_encdec_")
    try:
        for dec_type in ENCDEC_SERVE:
            phase_encdec_forward(dec_type)
            paths[f"encdec_{dec_type}_serve"] = phase_encdec_serve(dec_type, card)
            paths[f"encdec_{dec_type}_train"] = phase_encdec_train(dec_type, card)
            phase_encdec_restore(dec_type, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths["banded"] = phase_banded(card)
    return paths


# ---- phase 13: data parallel over torch.distributed (parallel/mesh.py) ----

def free_card() -> None:
    """Drop the garbage and cached blocks of a finished part."""
    gc.collect()
    torch.cuda.empty_cache()


def to_cpu(obj):
    """``obj`` with every tensor in it on the CPU (dicts and lists walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def bn_stats(model) -> dict:
    return {n: b.detach().cpu().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def ddp_small_batch(world: int, freeze_bn: bool) -> dict:
    """(a)'s global batch on the CPU: one pair of 64x128 a rank from phase
    3's generator, the images scaled by 1e-2 for the freeze_bn step."""
    batch = train_batch((world,) + DDP_SMALL, torch.Generator().manual_seed(4), "cpu")
    if freeze_bn:
        batch = dict(batch, left=batch["left"] * 1e-2, right=batch["right"] * 1e-2)
    return batch


def small_flags(freeze_bn: bool):
    """cuDNN as phase 3 holds each check: on in train mode, off for the
    freeze_bn gradients; TF32 off either way."""
    return torch.backends.cudnn.flags(enabled=not freeze_bn, allow_tf32=False)


DDP_SMALL_RUNS = {f"{'sync' if sync else 'local'} BN{', freeze_bn' if freeze else ''}": (sync, freeze)
                  for sync in (True, False) for freeze in (False, True)}


def ddp_small_step(mesh, sync: bool, freeze_bn: bool) -> dict:
    """(a) in one rank: one fp32 step of the flagship on this rank's pair;
    the reduced loss, summed confusions, averaged gradients and running
    statistics on the CPU."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import mesh_size, shard_batch

    model, state, step = train_setup("sdnet_mini_ext", mesh.device, bf16=False, freeze_bn=freeze_bn,
                                     mesh=mesh, sync_bn=sync)
    rows = {k: v.to(mesh.device)
            for k, v in shard_batch(mesh, ddp_small_batch(mesh_size(mesh), freeze_bn)).items()}
    with small_flags(freeze_bn):
        _, metrics = step(state, rows)
    return {"loss": metrics["loss"].item(), "conf": torch.stack([metrics["conf1"], metrics["conf2"]]).cpu(),
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "stats": bn_stats(model)}


def ddp_small_reference(world: int, sync: bool, freeze_bn: bool) -> dict:
    """(a)'s reference in one process on the card, from the same weights and
    the global batch: each pair's loss and gradient, with BatchNorm over
    every pair's maps (``sync`` in train mode: one forward of the batch) or
    over each pair's alone (one forward a pair, each from the same running
    statistics, which then take the mean of the pairs' updates); the mean of
    the losses and of the gradients (``freeze_bn``: BatchNorm's zeroed), the
    summed confusions. The gradients are averaged, not taken of the mean
    loss: MultiTversky's backward drops its output gradient, as the
    reference's does, so the mean loss has another gradient than the mean
    of the ranks'."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
        compute_metrics,
        make_forward_fn,
        make_losses_fn,
    )

    cfg = run_config("sdnet_mini_ext")
    cfg.loss.losses = TRAIN_LOSSES
    cfg.optim.freeze_bn = freeze_bn
    model = models.get_network(cfg, device="cuda", seed=0)
    forward, losses = make_forward_fn(cfg, model, "cuda"), make_losses_fn(cfg)
    batch = {k: v.cuda() for k, v in ddp_small_batch(world, freeze_bn).items()}
    rows = [{k: v[r:r + 1] for k, v in batch.items()} for r in range(world)]
    stats = {n: b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
    with small_flags(freeze_bn):
        if sync and not freeze_bn:
            out = forward(batch, True)
            outs = [{k: v[r:r + 1] for k, v in out.items() if isinstance(v, torch.Tensor)}
                    for r in range(world)]
        else:  # (with freeze_bn the statistics stay, and eval-mode BatchNorm saves them)
            start = {n: b.clone() for n, b in stats.items()}
            outs, ends = [], []
            for row in rows:
                if not freeze_bn:
                    with torch.no_grad():
                        for n, b in stats.items():
                            b.copy_(start[n])
                outs.append(forward(row, True))
                ends.append({n: b.clone() for n, b in stats.items()})
            if not freeze_bn:
                with torch.no_grad():
                    for n, b in stats.items():
                        b.copy_(sum(e[n] for e in ends) / world)
        row_losses = [losses(o, row)[0] for o, row in zip(outs, rows)]
        params = dict(model.named_parameters())
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        for row_loss in row_losses:
            for n, d in zip(params, torch.autograd.grad(row_loss, list(params.values()),
                                                       retain_graph=True, allow_unused=True)):
                if d is not None:
                    grads[n] += d / world
    if freeze_bn:
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                for n, _ in m.named_parameters(recurse=False):
                    grads[f"{name}.{n}"].zero_()
    with torch.no_grad():
        conf = sum(torch.stack([m["conf1"], m["conf2"]]) for m in (
            compute_metrics(cfg, {k: v.detach() for k, v in o.items() if isinstance(v, torch.Tensor)}, row)
            for o, row in zip(outs, rows)))
    return {"loss": sum(v.item() for v in row_losses) / world, "conf": conf.cpu(),
            "grads": {n: g.cpu() for n, g in grads.items()}, "stats": bn_stats(model)}


def allreduce_time(path: str, steps: int) -> dict:
    """From a ``utils/profiling.py:trace`` file of ``steps`` steps: the card's
    NCCL kernels (every all-reduce: the gradients', the statistics', the
    metrics', the cross-replica BatchNorm's) and all its kernels, ms and
    count a step."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if "nccl" in e.get("name", "").lower()]
    return {"nccl_ms": sum(e["dur"] for e in nccl) / 1e3 / steps, "nccl_kernels": len(nccl) / steps,
            "kernel_ms": sum(e["dur"] for e in kernels) / 1e3 / steps, "kernels": len(kernels) / steps}


def ddp_train(mesh, pairs: int, n_warmup: int, n_steps: int, trace_dir: str = None) -> dict:
    """(b) in one rank: the flagship's bf16 step (bench loss stack, Adam,
    BatchNorm cross-replica) on ``pairs`` pairs of 256x512 a rank, each
    rank its own; the host ms of each step (to a synchronize), the losses,
    each kernel's launches in the timed steps, the peak memory and the final
    weights and statistics. With ``trace_dir``, ``DDP_TRACE_STEPS`` more
    steps, traced on the mesh's rank 0 (``allreduce_time``)."""
    kernels = counters()
    model, state, step = train_setup("sdnet_mini_ext", mesh.device, bf16=True, mesh=mesh)
    g = torch.Generator(device=mesh.device).manual_seed(5 + 1000 * mesh.rank)
    batches = [train_batch((pairs, TRAIN_H, TRAIN_W), g, mesh.device)
               for _ in range(n_warmup + n_steps + (DDP_TRACE_STEPS if trace_dir else 0))]
    # ground-truth disparities in [0.1, 1), as phase 4's: the squared
    # relative error divides by them (torch.rand draws exact zeros)
    for batch in batches:
        batch["disp"] = batch["disp"] * 0.9 + 0.1
    torch.cuda.synchronize(mesh.device)
    free_card()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    times, losses = [], []
    for i, batch in enumerate(batches[:n_warmup + n_steps]):
        if i == n_warmup:
            zero_counts()
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize(mesh.device)
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
              f"ddp train rank {mesh.rank} step {i}: a metric or loss is not finite: {metrics}")
    out = {"ms": [1e3 * t for t in times], "losses": losses,
           "launches": {name: k.launches for name, k in kernels.items()},
           "peak_gib": torch.cuda.max_memory_allocated(mesh.device) / 2**30}
    if trace_dir is not None:
        from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils.profiling import trace

        traced = batches[n_warmup + n_steps:]
        with trace(trace_dir) if mesh.rank == 0 else contextlib.nullcontext():
            t0 = time.perf_counter()
            for batch in traced:
                step(state, batch)
            torch.cuda.synchronize(mesh.device)
            out["traced_ms"] = 1e3 * (time.perf_counter() - t0) / len(traced)
        if mesh.rank == 0:
            out.update(allreduce_time(os.path.join(trace_dir, "trace.json"), len(traced)))
    out["state"] = to_cpu(model.state_dict())
    return out


def ddp_cli(argv) -> dict:
    """(c) in one rank: ``cli.train.main(argv)`` joins the rank's group and
    trains and evaluates over the mesh; what it printed, each kernel's
    launches, the eval's rows and summary, and rank 0's final state."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.cli import train as cli

    kernels = zero_counts()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        session = cli.main(argv)
    torch.cuda.synchronize()
    out = {"printed": text.getvalue(), "launches": {name: k.launches for name, k in kernels.items()},
           "rows": session.accumulator.rows, "summary": session.eval_summary,
           "steps": len(session.timings["step_s"]), "model": to_cpu(session.model.state_dict())}
    if session.rank == 0:
        out["optimizer"] = to_cpu(session.state.optimizer.state_dict())
        out["step"] = session.state.step
    return out


def ddp_scale(mesh, trace_dir: str) -> dict:
    """--ddp: the bf16 step at ``TRAIN_BATCH`` pairs a card on the first 1,
    2 and 4 ranks (``DDP_SCALE_CARDS``; the others wait), each mesh's rank 0
    traced; {cards: ``ddp_train``'s result} on the ranks that ran."""
    import torch.distributed as dist

    from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import Mesh, mesh_size

    out = {}
    for cards in DDP_SCALE_CARDS:
        if cards > mesh_size(mesh):
            continue
        group = dist.new_group(list(range(cards)))  # every rank makes every group
        if mesh.rank < cards:
            group = group if cards > 1 else None
            sub = Mesh({"data": cards}, mesh.rank, mesh.device, group, group)
            out[cards] = ddp_train(sub, TRAIN_BATCH, DDP_WARMUP, DDP_SCALE_STEPS,
                                   os.path.join(trace_dir, f"cards{cards}"))
            del out[cards]["state"]
        free_card()
        dist.barrier()
    return out


def ddp_rank(rank: int, spec: dict) -> None:
    """One rank of phase 13, started by ``phase_ddp``: joins the group over
    ``spec["backend"]`` (NCCL: one card a rank, ``LOCAL_RANK``; gloo: the
    current card), runs (a)-(c) (and with ``spec["scale"]`` the scaling
    steps) and saves its results to ``{out}/rank{rank}.pt``."""
    import torch.distributed as dist

    from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import (
        make_mesh,
        setup_distributed,
    )

    if spec["backend"] == "nccl":
        os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    setup_distributed(backend=spec["backend"], coordinator=f"localhost:{spec['port']}",
                      num_processes=spec["world"], process_id=rank)
    mesh = make_mesh()
    out = {"card": torch.cuda.current_device(), "seconds": {}}
    parts = {"small": lambda: {run: ddp_small_step(mesh, *flags) for run, flags in DDP_SMALL_RUNS.items()},
             "train": lambda: ddp_train(mesh, DDP_PAIRS, DDP_WARMUP, DDP_STEPS),
             "cli": lambda: ddp_cli(spec["argv"])}
    if spec["scale"]:
        parts["scale"] = lambda: ddp_scale(mesh, spec["trace_dir"])
    for part, run in parts.items():
        t0 = time.perf_counter()
        out[part] = run()
        free_card()
        out["seconds"][part] = time.perf_counter() - t0
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(world: int, spec: dict) -> None:
    """Start ``world`` processes of ``ddp_rank`` and wait for them (at most
    ``DDP_TIMEOUT_S``); a rank that fails or outlasts the limit fails the
    phase, and no rank outlives this call."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(ddp_rank, args=(spec,), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DDP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, f"phase 13: ranks still running after {DDP_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SmokeFailure(f"phase 13: a rank failed: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(30)


def eval_rows_of(rank: int, world: int, batch: int) -> int:
    """The real rows rank ``rank`` of ``world`` evaluates of (c)'s test pairs
    at ``-b batch`` (one eval batch: ``eval_batch_size`` rows, the tail
    padded)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training.loop import eval_batch_size

    local = eval_batch_size(batch, FILES_TEST_PAIRS, world) // world
    return max(0, min(local, FILES_TEST_PAIRS - rank * local))


def phase_ddp(card: str, nccl: bool = False) -> dict:
    """Phase 13: the port's data-parallel layer, ``DDP_RANKS`` ranks over
    gloo on the one card (``nccl``: one rank on each visible card over NCCL,
    two or more); returns corr1d's and its backward's launches in each rank
    in (b) and (c).

    (a) fp32 (TF32 off): the flagship at full width and depth, one pair of
    64x128 a rank, against one process on every rank's pairs with the same
    weights (``ddp_small_reference``), with BatchNorm cross-replica and per
    replica: in train mode the loss, the summed confusions and every running
    statistic within 1e-3 * max|ref|; with ``freeze_bn`` on images scaled by
    1e-2 and cuDNN off, every gradient tensor within 1e-3 * max|ref|; every
    rank's reduced values equal rank 0's. (b) bf16: the flagship's step on
    ``DDP_PAIRS`` pairs of 256x512 a rank, 2 warm-up and 4 timed steps:
    finite, corr1d's forward and backward once a step on every rank, the
    replicas' weights and statistics bit-equal after the steps; ms/step is a
    reading. (c) From phase 8's files through ``cli.train.main`` in each
    rank, one epoch and the sharded eval: rank 0 alone prints and writes the
    checkpoint; a fresh one-card ``Session`` restores it bit-equal to rank
    0's state; the sharded eval's table equals the one-card eval CLI's from
    that checkpoint within ``FILES_EVAL_RTOL``. With ``nccl``, the scaling
    steps of ``ddp_scale`` too: ms/step, pairs/s and the all-reduces' share
    of a step on 1, 2 and 4 cards."""
    import socket

    from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config_from_args
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session

    world = torch.cuda.device_count() if nccl else DDP_RANKS
    check(world >= 2, f"phase 13 needs two ranks or more, found {world} cards")
    backend = "nccl" if nccl else "gloo"
    where = f"{world} ranks over {backend}, " + ("one a card" if nccl else "all on cuda:0")
    tmp = tempfile.mkdtemp(prefix="pmt_ddp_")
    try:
        refs = {run: ddp_small_reference(world, *flags) for run, flags in DDP_SMALL_RUNS.items()}
        free_card()
        data = files_fixture(os.path.join(tmp, "ds"))
        argv = data + DDP_FILES + ["-w_savePath", os.path.join(tmp, "runs")]
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        spec = {"world": world, "backend": backend, "port": port, "argv": argv, "out": tmp,
                "scale": nccl, "trace_dir": os.path.join(tmp, "traces")}
        t0 = time.perf_counter()
        run_ranks(world, spec)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu", weights_only=False)
                 for r in range(world)]
        print(f"[ddp] {where}: the ranks ran in {time.perf_counter() - t0:.1f} s, startup included "
              f"(rank 0, s: " + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items())
              + ")", flush=True)
        check([r["card"] for r in ranks] == (list(range(world)) if nccl else [0] * world),
              f"phase 13: ranks on cards {[r['card'] for r in ranks]}")

        # (a) against one process on every rank's pairs
        for run, (sync, freeze) in DDP_SMALL_RUNS.items():
            tag = f"[ddp fp32 {world}x1x64x128 {run}]"
            got, ref = ranks[0]["small"][run], refs[run]
            hold_loss(tag, got["loss"], ref["loss"], (f"{world} ranks", "one process"))
            err, bound = (got["conf"] - ref["conf"]).abs().max().item(), 1e-3 * ref["conf"].abs().max().item()
            print(f"{tag} confusion sums max|d| = {err:.6g} (tolerance {bound:.6g} = 1e-3 * max|ref|)",
                  flush=True)
            check(err <= bound, f"{tag}: confusion sums {got['conf']} against {ref['conf']}")
            if freeze:
                hold_tensors(tag + " cuDNN off", "gradient", got["grads"], ref["grads"], "one process's")
            else:
                hold_tensors(tag, "BN running statistic", got["stats"], ref["stats"], "one process's")
            for r, other in enumerate(ranks[1:], 1):
                theirs = other["small"][run]
                check(theirs["loss"] == got["loss"] and torch.equal(theirs["conf"], got["conf"]),
                      f"{tag}: rank {r}'s reduced loss or confusions differ from rank 0's")
                same_tensors(f"{tag} rank {r} gradients", theirs["grads"], got["grads"])
                same_tensors(f"{tag} rank {r} statistics", theirs["stats"], got["stats"])
        print(f"[ddp fp32] every rank's reduced loss, confusions, gradients and statistics equal rank "
              f"0's in all {len(DDP_SMALL_RUNS)} runs", flush=True)

        # (b) the bf16 step
        launches = {"train": {}, "cli": {}}
        for name in ("corr1d", "corr1d_backward", "corr2d", "corr2d_backward"):
            launches["train"][name] = [r["train"]["launches"][name] for r in ranks]
            per_step = 1 if name.startswith("corr1d") else 0
            check(launches["train"][name] == [per_step * DDP_STEPS] * world,
                  f"ddp train: {name} launched {launches['train'][name]} times on the ranks in "
                  f"{DDP_STEPS} steps, expected {per_step} a step on each")
        for r, other in enumerate(ranks[1:], 1):
            same_tensors(f"[ddp train] rank {r}'s weights and statistics", other["train"]["state"],
                         ranks[0]["train"]["state"])
        t = ranks[0]["train"]
        ms = float(np.mean(t["ms"][DDP_WARMUP:]))
        print(f"[ddp train] {where}: flagship densenet121 bf16, CE + Lovasz + MultiTversky + OHEM, "
              f"Adam, cross-replica BN, {DDP_PAIRS} pairs of {TRAIN_H}x{TRAIN_W} a rank "
              f"({DDP_PAIRS * world} a step): {ms:.2f} ms/step, {DDP_PAIRS * world / ms * 1e3:.2f} "
              f"training pairs/s over {DDP_STEPS} steps (rank 0, per step: "
              f"{', '.join(f'{v:.2f}' for v in t['ms'])} ms, the first {DDP_WARMUP} warm-ups)"
              f"{'; a reading: the ranks share one card' if not nccl else ''}; losses "
              f"{', '.join(f'{v:.5g}' for v in t['losses'])}; peak memory a rank "
              f"{', '.join(f'{r['train']['peak_gib']:.2f}' for r in ranks)} GiB; replicas bit-equal "
              f"after the steps; launches a rank {launches['train']}; {card}", flush=True)

        # (c) the CLI in every rank, then one card from its checkpoint
        cfg = config_from_args(argv)
        ckpt = os.path.join(tmp, "runs", cfg.model_id())
        steps = FILES_TRAIN_PAIRS // cfg.run.batch
        files = sorted(os.listdir(ckpt))
        check("meta_0.json" in files and "best.json" in files
              and len([f for f in files if f.startswith("model_best_IOU")]) == 1,
              f"ddp files: checkpoint directory {ckpt}: {files}")
        zero = ranks[0]["cli"]
        check("model id:" in zero["printed"] and "final eval:" in zero["printed"],
              "ddp files: rank 0 printed no model id or final eval")
        for r, res in enumerate(ranks):
            c = res["cli"]
            check(r == 0 or c["printed"] == "", f"ddp files: rank {r} printed {c['printed'][:200]!r}")
            own = eval_rows_of(r, world, cfg.run.batch)
            expect = {"corr1d": c["steps"] + own, "corr1d_backward": c["steps"], "corr2d": 0,
                      "corr2d_backward": 0}
            check(c["steps"] == steps and c["launches"] == expect,
                  f"ddp files rank {r}: {c['steps']} steps, launches {c['launches']}, expected {expect}")
            same_tensors(f"[ddp files] rank {r}'s final state", c["model"], zero["model"])
            check(len(c["rows"]) == FILES_TEST_PAIRS, f"ddp files rank {r}: {len(c['rows'])} eval rows")
        for name in ("corr1d", "corr1d_backward"):
            launches["cli"][name] = [r["cli"]["launches"][name] for r in ranks]
        fresh = Session(config_from_args(argv + ["-load_weights", ckpt]))
        fresh.init_state(steps_per_epoch=steps)
        check(fresh.restore(ckpt)[0] == 1, "ddp files: restore's start epoch")
        same_tensors("[ddp files restore] model", to_cpu(fresh.model.state_dict()), zero["model"])
        same_tensors("[ddp files restore] optimizer", to_cpu(fresh.state.optimizer.state_dict()),
                     zero["optimizer"])
        check(fresh.state.step == zero["step"], "ddp files restore: step")
        del fresh
        free_card()
        print(f"[ddp files] {where}: one epoch of {steps} steps of {cfg.run.batch} pairs from "
              f"phase 8's PNGs through cli.train.main in each rank and the sharded eval of "
              f"{FILES_TEST_PAIRS} pairs (rows a rank "
              f"{[eval_rows_of(r, world, cfg.run.batch) for r in range(world)]}); "
              f"rank 0 alone printed and wrote {os.path.basename(ckpt)}; the replicas' final states "
              f"bit-equal; a one-card Session restores rank 0's weights, statistics, optimizer state "
              f"and step bit-equal; launches a rank {launches['cli']}", flush=True)
        kernels = counters()
        with contextlib.chdir(tmp):
            ev, _, one_card = cli_run(data + DDP_FILES + ["-train", "0", "-b", str(FILES_TEST_PAIRS),
                                                          "-load_weights", ckpt], kernels)
        hold_cli_launches("[ddp files one-card eval]", ev, one_card)
        hold_eval_tables("[ddp files] the sharded eval vs the one-card eval CLI from its checkpoint",
                         eval_table(zero["rows"], zero["summary"]),
                         eval_table(ev.accumulator.rows, ev.eval_summary))
        del ev
        free_card()
        if nccl:
            launches["scale"] = phase_ddp_scale(ranks, card)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 14: the CLI's default precision (fp32, no -f16) ----

# cuDNN's and cuBLAS's TF32 switches as torch starts, before main() turns
# them off for the held comparisons: what the program runs under, since the
# port sets neither
PROGRAM_TF32 = {"cudnn": torch.backends.cudnn.allow_tf32,
                "matmul": torch.backends.cuda.matmul.allow_tf32}


@contextlib.contextmanager
def program_precision():
    """TF32 as the program leaves it (``PROGRAM_TF32``) inside the block;
    printed on entry."""
    held = {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = PROGRAM_TF32["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = PROGRAM_TF32["matmul"]
    print(f"[fp32] torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32} (as the "
          f"program leaves them: the port sets neither)", flush=True)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = held["cudnn"]
        torch.backends.cuda.matmul.allow_tf32 = held["matmul"]


def phase_fp32(card: str) -> dict:
    """Phase 14: sdnet in fp32, the CLI's default precision, at full width
    and depth: serving ``BATCH`` pairs of ``H``x``W`` (corr2d once a batch),
    training at ``TRAIN_BATCH`` pairs of 256x512 (corr2d and its backward
    once a step), then ``cli.train.main`` without ``-f16`` on phase 8's files
    (``FP32_FILES``: one epoch of 2 steps and the eval of the 5 test pairs:
    corr2d once a step and once an eval forward, its backward once a step,
    corr1d never). Returns each path's launches."""
    free_card()
    out = {}
    with program_precision():
        out["serve"] = phase_serve("sdnet", FP32_SERVE_BATCHES, SERVE["sdnet"][1], bf16=False)
        free_card()
        out["train"] = phase_train("sdnet", TRAIN_WARMUP, FP32_TRAIN_STEPS, card, bf16=False)
        free_card()
        tmp = tempfile.mkdtemp(prefix="pmt_fp32_")
        try:
            data = files_fixture(os.path.join(tmp, "ds"))
            session, _, launches = cli_run(data + FP32_FILES + ["-w_savePath", os.path.join(tmp, "runs")],
                                           counters())
            check(not session.cfg.parallel.bf16, "the fp32 CLI run took the bf16 policy")
            t = session.timings
            check(len(t["step_s"]) == 2 and t["eval_rows"] == FILES_TEST_PAIRS, f"fp32 CLI: {t}")
            hold_cli_launches("[fp32 cli]", session, launches, corr="corr2d")
            print(f"[fp32 cli] sdnet densenet121 fp32 from PNGs, 8 pairs of 256x512 a step: each step "
                  f"with loading, ms: {step_times(t)}; eval of {t['eval_rows']} pairs at 512x960: "
                  f"{t['eval_rows'] / t['eval_s']:.2f} pairs/s; launches {launches}; {card}", flush=True)
            out["cli"] = launches
            del session
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- phase 15: the learning gate (tools/overfit_smoke.py) ----

def overfit_run(tag: str, seed: int, bf16: bool, flagship: bool, card: str, fault: bool = False) -> dict:
    """One run of the overfit tool's configuration on the card (the flagship
    at ``overfit_smoke.FLAGSHIP`` where ``flagship``; the gate's negative
    control ``overfit_smoke.LabelFault`` where ``fault``), in a Session of
    its own from the seeded init ``seed``: the tool's line, the held readout
    (``overfit_smoke.batch_statistics_miou``), the first and last epoch's
    train loss, ms a step, peak memory and each kernel's launches in
    ``fit``, the counts set to 0 just before it."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.tools import overfit_smoke as tool
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session

    free_card()
    tmp = tempfile.mkdtemp(prefix="pmt_overfit_")
    try:
        cfg = tool.overfit_config(tmp, OVERFIT_EPOCHS, bf16, seed, flagship)
        session = (tool.LabelFault if fault else Session)(cfg)
        check(session.device.type == "cuda", f"{tag}: the Session took {session.device}")
        torch.cuda.reset_peak_memory_stats()
        kernels = zero_counts()
        t0 = time.perf_counter()
        ev = tool.last_row(session)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        held = tool.batch_statistics_miou(session)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = tool.result(ev, OVERFIT_EPOCHS)
    losses = [float(m["loss"]) for m in session.train_history]
    t = session.timings
    check(len(t["step_s"]) == OVERFIT_EPOCHS * OVERFIT_STEPS_PER_EPOCH == len(losses) * OVERFIT_STEPS_PER_EPOCH
          and t["eval_rows"] == OVERFIT_EVAL_ROWS,
          f"{tag}: {len(t['step_s'])} train steps and {t['eval_rows']} eval rows, expected "
          f"{OVERFIT_EPOCHS * OVERFIT_STEPS_PER_EPOCH} and {OVERFIT_EVAL_ROWS}")
    check(all(np.isfinite(v) for v in losses) and all(np.isfinite(float(v)) for v in ev.values())
          and np.isfinite(held),
          f"{tag}: a train loss or eval value is not finite: losses {losses}, eval {ev}, {held}")
    check(launches == OVERFIT_LAUNCHES, f"{tag}: launches {launches}, expected {OVERFIT_LAUNCHES} "
          f"({OVERFIT_EPOCHS * OVERFIT_STEPS_PER_EPOCH} train steps, {OVERFIT_EVAL_ROWS} eval rows)")
    if fault:
        check(held < OVERFIT_HELD_MIOU,
              f"{tag}: the planted label fault reads {held:.4f}, not below the held limit "
              f"{OVERFIT_HELD_MIOU}: the hold does not tell a port that learns from one that does not")
    else:
        check(held >= OVERFIT_HELD_MIOU,
              f"{tag}: mIoU(head 2) with the batch's own statistics {held:.4f} < {OVERFIT_HELD_MIOU} "
              f"(the tool's eval {float(ev['miou2']):.4f}): the port did not learn the 8 pairs")
        check(losses[-1] <= OVERFIT_LOSS_DROP * losses[0],
              f"{tag}: the last epoch's train loss {losses[-1]} is not at most {OVERFIT_LOSS_DROP} of "
              f"the first's {losses[0]}")
    after_first = t["step_s"][OVERFIT_STEPS_PER_EPOCH:]
    out = {**line, "seed": seed, "miou2": float(ev["miou2"]), "batch_statistics_miou2": held,
           "train_loss_first": losses[0], "train_loss_last": losses[-1],
           "ms_per_step": 1e3 * float(np.mean(after_first)),
           "load_wait_ms": 1e3 * float(np.mean(t["load_wait_s"][OVERFIT_STEPS_PER_EPOCH:])),
           "peak_gib": peak, "seconds": seconds, "launches": launches}
    print(f"[overfit {tag}] {json.dumps(line)} (the tool's gate: mIoU(head 2) > {tool.GATE}, a reading); "
          f"held: mIoU(head 2) with the batch's own statistics {held:.6f} "
          f"({'below' if fault else 'at least'} {OVERFIT_HELD_MIOU}); train loss, first epoch {losses[0]:.6g}, last "
          f"{losses[-1]:.6g}; {out['ms_per_step']:.2f} ms a step after the first epoch (loader wait "
          f"{out['load_wait_ms']:.2f}); peak memory {peak:.2f} GiB; {seconds:.1f} s; launches {launches} "
          f"(expected {OVERFIT_LAUNCHES}); {card}", flush=True)
    return out


def phase_overfit(card: str) -> dict:
    """Phase 15: the overfit tool's configuration on the card at full width
    and depth: sdnet_mini in fp32 and under the bf16 policy at each of
    ``OVERFIT_SEEDS``, the flagship in fp32 at seed 0, TF32 as the program
    leaves it, then the negative control (``LabelFault``, fp32, seed 0).
    Holds every run finite and its launches exact; every run that learns at
    or above ``OVERFIT_HELD_MIOU`` on the held readout with its train loss
    down to ``OVERFIT_LOSS_DROP`` of its first epoch's, and the control
    below it. The tool's line (its eval on the running statistics and its
    ``pass``) and each configuration's medians are printed beside the JAX
    package's CPU readings (``OVERFIT_JAX_CPU``), not held: at 40 epochs
    the tool's eval swings between neighbouring epochs in both packages
    (PERF.md section 6, the overfit gate). Returns {sdnet_mini: each kernel's launches
    in each run, flagship: its run's}."""
    t0 = time.perf_counter()
    runs = {}
    with program_precision():
        for bf16 in (False, True):
            name = f"sdnet_mini {'bf16' if bf16 else 'fp32'}"
            runs[name] = [overfit_run(f"{name} seed {s}", s, bf16, False, card) for s in OVERFIT_SEEDS]
        runs["flagship fp32"] = [overfit_run("flagship fp32 seed 0", 0, False, True, card)]
        control = overfit_run("sdnet_mini fp32 seed 0, labels rolled (the control)", 0, False, False, card,
                              fault=True)
    summary = {}
    for name, rs in runs.items():
        evals = [r["miou2"] for r in rs]
        held = [r["batch_statistics_miou2"] for r in rs]
        summary[name] = {"miou2": evals, "median": float(np.median(evals)), "pass": [r["pass"] for r in rs],
                         "batch_statistics_miou2": held, "batch_statistics_median": float(np.median(held)),
                         "jax_cpu_miou2": OVERFIT_JAX_CPU[name],
                         "ms_per_step": [r["ms_per_step"] for r in rs], "peak_gib": [r["peak_gib"] for r in rs],
                         "train_loss_first_last": [[r["train_loss_first"], r["train_loss_last"]] for r in rs]}
        jax_median = float(np.median(OVERFIT_JAX_CPU[name]))
        print(f"[overfit {name}] the tool's eval mIoU(head 2) {', '.join(f'{v:.4f}' for v in evals)} "
              f"(median {summary[name]['median']:.4f}; the JAX tool's on the CPU at the same seeds "
              f"{', '.join(f'{v:.4f}' for v in OVERFIT_JAX_CPU[name])}, median {jax_median:.4f}, "
              f"the port's median {summary[name]['median'] - jax_median:+.4f} from it): readings, not held; held, "
              f"with the batch's own statistics "
              f"{', '.join(f'{v:.4f}' for v in held)} (at least {OVERFIT_HELD_MIOU} each)", flush=True)
    summary["control"] = {"batch_statistics_miou2": control["batch_statistics_miou2"], "miou2": control["miou2"]}
    seconds = time.perf_counter() - t0
    print(f"[overfit] {sum(len(rs) for rs in runs.values())} runs and the control in {seconds:.1f} s; {card}",
          flush=True)
    print(json.dumps({"overfit": summary, "held_miou": OVERFIT_HELD_MIOU, "seconds": seconds}), flush=True)
    return {"sdnet_mini": {k: [r["launches"][k] for name in ("sdnet_mini fp32", "sdnet_mini bf16")
                               for r in runs[name]] for k in OVERFIT_LAUNCHES},
            "flagship": runs["flagship fp32"][0]["launches"]}


# ---- phase 16: the launch scripts, run unmodified ----

def script_probe(argv: list) -> int:
    """Phase 16's ``python`` (``chip_smoke.py --script-probe -m MODULE ARGS``):
    a launch script's ``python -m MODULE ARGS``, run as it is by ``runpy``,
    with every kernel's count set to 0 just before; then writes to the file
    ``$PMT_SCRIPT_PROBE`` (JSON) the arguments, each kernel's launches, and
    the run's last Session: its model id, precision, device, timings, train
    losses, eval summary and rows, and the card's peak memory."""
    import runpy

    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import loop

    if argv[:1] != ["-m"] or len(argv) < 2:
        print(f"chip_smoke --script-probe: expected -m MODULE ARGS, got {argv}", file=sys.stderr)
        return 2
    sessions = []
    init = loop.Session.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        sessions.append(self)

    loop.Session.__init__ = record
    kernels = zero_counts()
    sys.argv = argv[1:]
    runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    session = sessions[-1]
    out = {"argv": argv, "launches": {name: k.launches for name, k in kernels.items()},
           "model_id": session.cfg.model_id(), "bf16": session.cfg.parallel.bf16,
           "device": str(session.device), "timings": session.timings,
           "train_loss": [float(m["loss"]) for m in session.train_history],
           "summary": {k: float(v) for k, v in session.eval_summary.items()},
           "summary_text": str(session.eval_summary),
           "rows": [{k: float(v) for k, v in r.items()} for r in session.accumulator.rows],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    with open(os.environ["PMT_SCRIPT_PROBE"], "w") as f:
        json.dump(out, f, default=float)
    return 0


def scripts_fixture(root: str) -> None:
    """Phase 16's dataset directory ``root``: a roses fixture from the port's
    ``make_roses_fixture`` (``SCRIPTS_TRAIN_PAIRS`` + ``SCRIPTS_VAL_PAIRS``
    training and ``SCRIPTS_TEST_PAIRS`` test pairs of ``SCRIPTS_HW``) listed
    in the scripts' manifests (``colorL_train.txt`` ... ``inst_val.txt``,
    ``*_test.txt``, absolute paths); then the root
    ``scripts/reduce_existent_dataset.py``, run there as users run it,
    writes ``reduced_size/*__small.txt``."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import make_roses_fixture

    fixture = make_roses_fixture(root, n_train=SCRIPTS_TRAIN_PAIRS + SCRIPTS_VAL_PAIRS,
                                 n_test=SCRIPTS_TEST_PAIRS, hw=SCRIPTS_HW, seed=0)

    def listed(key):
        with open(fixture[key]) as f:
            return [os.path.join(root, line.strip()) for line in f if line.strip()]

    manifests = {}
    for kind, key in (("colorL", "left"), ("colorR", "right"), ("seg", "seg"), ("disp", "disp"),
                      ("inst", "inst")):
        train = listed(key)
        for split, files in (("train", train[:SCRIPTS_TRAIN_PAIRS]), ("val", train[SCRIPTS_TRAIN_PAIRS:]),
                             ("test", listed(key + "_t"))):
            manifests[f"{kind}_{split}.txt"] = files
            with open(os.path.join(root, f"{kind}_{split}.txt"), "w") as f:
                f.write("\n".join(files) + "\n")
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "reduce_existent_dataset.py"), *manifests],
                          cwd=root, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"[scripts] reduce_existent_dataset.py: {proc.stdout}{proc.stderr}")
    for name, files in manifests.items():
        with open(os.path.join(root, "reduced_size", name.replace(".txt", "__small.txt"))) as f:
            check(f.read().split() == files, f"[scripts] reduced_size's {name} lists other files")


def run_script(tag: str, argv: list, cwd: str, bin_dir: str, probe: str):
    """``bash`` ``argv`` (a launch script and its arguments) in ``cwd`` with
    phase 16's ``python`` (``bin_dir``) first on ``PATH`` and the checkout on
    ``PYTHONPATH``; returns (its stdout, the probe's record, seconds). The
    script's processes run in a session of their own, killed with it at
    ``SCRIPTS_TIMEOUT_S`` or on any error here."""
    env = {**os.environ, "PATH": os.pathsep.join([bin_dir, os.environ.get("PATH", "")]),
           "PYTHONPATH": os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
           "PMT_SCRIPT_PROBE": probe}
    t0 = time.perf_counter()
    proc = subprocess.Popen(["bash", *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        text, err = proc.communicate(timeout=SCRIPTS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{tag}: {os.path.basename(argv[0])} still running after {SCRIPTS_TIMEOUT_S} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{tag}: {os.path.basename(argv[0])} exited {proc.returncode}; its "
          f"output ends:\n{text[-3000:]}\n{err[-3000:]}")
    with open(probe) as f:
        record = json.load(f)
    bad = re.findall(r".*\b(?:nan|inf)\b.*", text, re.I)
    check(not bad, f"{tag}: a printed loss or metric is not finite: {bad[:3]}")
    check(not record["bf16"] and record["device"].startswith("cuda"),
          f"{tag}: ran with bf16 {record['bf16']} on {record['device']}, not fp32 on the card")
    return text, record, seconds


def corr1d_fp32_times(shapes: dict, tag: str, card: str) -> list:
    """corr1d's fp32 forward at ``shapes`` (where -> shape) against
    ``correlation_plain`` (1e-4 * max|ref|), timed back to back and each
    launch alone (warm, behind a card-side spin), beside its plain version
    and its bound; returns a record a shape."""
    correlation = correlation_module()
    patch = correlation.KERNEL_PATCH["corr1d"]
    fn = wrapper("corr1d")
    g = torch.Generator(device="cuda").manual_seed(16)
    out = []
    for where, shape in shapes.items():
        f1, f2 = (inputs(shape, torch.float32, g) for _ in range(2))
        got = fn(f1, f2, patch[1])
        torch.cuda.synchronize()
        ref = correlation.correlation_plain(f1, f2, patch)
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        check(got.shape == ref.shape and err <= tol,
              f"{tag} corr1d fp32 {shape}: shape {tuple(got.shape)}, max|d| {err} > {tol}")
        ms = cuda_time_ms(lambda: fn(f1, f2, patch[1]), iters=50)
        alone_ms, alone_median = event_time_ms(lambda: fn(f1, f2, patch[1]), 50, flush=False)
        plain_ms = cuda_time_ms(lambda: correlation.correlation_plain(f1, f2, patch), iters=3, warmup=1)
        nbytes = (f1.numel() + f2.numel() + got.numel()) * f1.element_size()
        bound_ms, bound_by = byte_bound_ms(nbytes, 2 * got.numel() * shape[-1], torch.float32)
        print(f"{tag} corr1d fp32 at the {where}'s {tuple(shape)}: max|d| = {err:.6g} (tolerance "
              f"{tol:.6g} = 1e-4 * max|ref|); kernel {ms:.4f} ms back to back, {alone_ms:.4f} ms a launch "
              f"alone (warm; median {alone_median:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({nbytes / 1e6:.1f} MB), {bound_ms / alone_ms:.1%} of the bound alone; {card}",
              flush=True)
        out.append({"where": where, "shape": list(shape), "dtype": "float32", "ms": ms, "ms_alone": alone_ms,
                    "ms_alone_median": alone_median, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": err})
        del f1, f2, got, ref
    return out


def phase_scripts(card: str) -> dict:
    """Phase 16: the port's copies of the launch scripts, run unmodified by
    bash from a working directory of their own with a ``python`` first on
    ``PATH`` that starts ``script_probe``: ``train_flagship.sh DATA small``
    (the flagship in fp32, ``SCRIPTS_STEPS`` steps, an eval every
    ``SCRIPTS_EVAL_EVERY`` epochs), then ``eval_flagship.sh DATA CKPT`` on
    its checkpoint. Holds both exit 0, the checkpoint's files, the eval's
    summary as its last line and its result images, every printed number
    finite, fp32 on the card, corr1d once a train step and once an eval row
    and its backward once a train step, in each script's process; and the
    eval script's summary table against ``cli.train.main`` run here on the
    same arguments and checkpoint within ``FILES_EVAL_RTOL``. Holds and
    times corr1d's fp32 forward at the path's shapes first. Returns
    {train, eval: each kernel's launches in that script's process,
    corr1d_fp32: the timed shapes}."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import png

    t0 = time.perf_counter()
    free_card()
    timed = corr1d_fp32_times(SCRIPTS_CORR_SHAPES, "[scripts]", card)
    free_card()
    scripts = ROOT / SCRIPTS
    tmp = tempfile.mkdtemp(prefix="pmt_scripts_")
    try:
        data, work, bin_dir = (os.path.join(tmp, d) for d in ("roses", "work", "bin"))
        for d in (work, bin_dir):
            os.makedirs(d)
        scripts_fixture(data)
        shim = os.path.join(bin_dir, "python")
        with open(shim, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "{os.path.abspath(__file__)}" --script-probe "$@"\n')
        os.chmod(shim, 0o755)

        # (a), (b): training, 100 epochs of one step
        text, train, seconds = run_script("[scripts train]", [str(scripts / "train_flagship.sh"), data, "small"],
                                          work, bin_dir, os.path.join(tmp, "train.json"))
        t = train["timings"]
        check(len(t["step_s"]) == SCRIPTS_STEPS and t["eval_rows"] == SCRIPTS_TRAIN_EVAL_ROWS,
              f"[scripts train] {len(t['step_s'])} steps and {t['eval_rows']} eval rows, expected "
              f"{SCRIPTS_STEPS} and {SCRIPTS_TRAIN_EVAL_ROWS}")
        check(all(np.isfinite(train["train_loss"])) and all(np.isfinite(list(train["summary"].values()))),
              f"[scripts train] a train loss or eval value is not finite: {train['train_loss']}, "
              f"{train['summary']}")
        hold_cli_launches("[scripts train]", types.SimpleNamespace(timings=t), train["launches"])
        ckpt = os.path.join(work, "results", train["model_id"])
        files = sorted(os.listdir(ckpt))
        best = [f for f in files if f.startswith("model_best_IOU") and "_Derr" in f]
        check(any(f.startswith("meta_") and f.endswith(".json") for f in files) and "best.json" in files
              and len(best) == 1, f"[scripts train] checkpoint directory {ckpt}: {files}")
        train_out = {"seconds": seconds, "ms_per_step": 1e3 * float(np.mean(t["step_s"][1:])),
                     "load_wait_ms": 1e3 * float(np.mean(t["load_wait_s"][1:])),
                     "first_step_ms": 1e3 * t["step_s"][0], "eval_pairs_per_s": t["eval_rows"] / t["eval_s"],
                     "peak_gib": train["peak_gib"], "train_loss_first_last": [train["train_loss"][0],
                                                                              train["train_loss"][-1]],
                     "launches": train["launches"]}
        print(f"[scripts train] bash {SCRIPTS}/train_flagship.sh DATA small: the flagship densenet121 fp32 (no "
              f"-f16) from PNGs, {TRAIN_BATCH} pairs of {TRAIN_H}x{TRAIN_W} a step, {SCRIPTS_STEPS} steps: "
              f"{train_out['ms_per_step']:.2f} ms a step with loading over steps 2-{SCRIPTS_STEPS}, of which the "
              f"loader wait {train_out['load_wait_ms']:.2f} (the first step {train_out['first_step_ms']:.1f}); "
              f"train loss {train['train_loss'][0]:.4f} -> {train['train_loss'][-1]:.4f}; "
              f"{t['eval_rows']} eval rows at 512x960: {train_out['eval_pairs_per_s']:.2f} pairs/s; peak "
              f"memory {train['peak_gib']:.2f} GiB; launches {train['launches']}; {seconds:.1f} s for the "
              f"script; checkpoint {files}; {card}", flush=True)

        # (a), (b): the eval script on that checkpoint
        text, ev, seconds = run_script("[scripts eval]", [str(scripts / "eval_flagship.sh"), data, ckpt],
                                       work, bin_dir, os.path.join(tmp, "eval.json"))
        t = ev["timings"]
        check(t["eval_rows"] == SCRIPTS_TEST_PAIRS and not t["step_s"], f"[scripts eval] {t}")
        check(text.strip().splitlines()[-1] == ev["summary_text"],
              "[scripts eval] the summary is not the last line printed")
        check(all(np.isfinite(list(ev["summary"].values()))), f"[scripts eval] {ev['summary']}")
        hold_cli_launches("[scripts eval]", types.SimpleNamespace(timings=t), ev["launches"])
        results = os.path.join(work, "testResults")
        shown = sorted(os.listdir(results))
        for head in (1, 2):
            heatmap = png.read(os.path.join(results, f"confusion_head{head}.png"))
            check(heatmap.ndim == 3 and heatmap.shape[2] == 3 and heatmap.shape[0] == heatmap.shape[1] > 0,
                  f"[scripts eval] confusion_head{head}.png decodes to {heatmap.shape}")
        check(sum(f.endswith(".jpg") for f in shown) == 4 * SCRIPTS_TEST_PAIRS,
              f"[scripts eval] testResults holds {shown}")
        eval_out = {"seconds": seconds, "pairs_per_s": t["eval_rows"] / t["eval_s"], "peak_gib": ev["peak_gib"],
                    "launches": ev["launches"]}
        print(f"[scripts eval] bash {SCRIPTS}/eval_flagship.sh DATA CKPT: {t['eval_rows']} pairs at -b 1 "
              f"-show_results 1 in the 512x960 bucket: {eval_out['pairs_per_s']:.2f} pairs/s (host, loading and "
              f"the result images included); the summary is the last line; testResults: {shown}; peak memory "
              f"{ev['peak_gib']:.2f} GiB; launches {ev['launches']}; {seconds:.1f} s for the script; {card}",
              flush=True)

        # (c): the eval script's summary against cli.train.main on its arguments here
        cwd = os.path.join(tmp, "in_process")
        os.makedirs(cwd)
        with program_precision(), contextlib.chdir(cwd):
            session, _, launches = cli_run(ev["argv"][2:], counters())
        hold_cli_launches("[scripts eval in process]", session, launches)
        hold_eval_tables("[scripts] the eval script vs cli.train.main on its arguments",
                         eval_table(ev["rows"], ev["summary"]),
                         eval_table(session.accumulator.rows, session.eval_summary))
        del session
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"[scripts] phase 16 in {seconds:.1f} s; {card}", flush=True)
    print(json.dumps({"scripts": {"train": train_out, "eval": eval_out, "corr1d_fp32": timed,
                                  "seconds": seconds}}), flush=True)
    return {"train": train["launches"], "eval": ev["launches"], "corr1d_fp32": timed}


def phase_ddp_scale(ranks: list, card: str) -> dict:
    """--ddp: print the scaling steps' readings; returns {cards: {ms/step,
    pairs/s, the NCCL kernels' ms a step and share of it}} (rank 0's)."""
    out = {}
    for cards, t in ranks[0]["scale"].items():
        ms = float(np.mean(t["ms"][DDP_WARMUP:]))
        for r in range(cards):
            got = ranks[r]["scale"][cards]["launches"]
            check(got["corr1d"] == got["corr1d_backward"] == DDP_SCALE_STEPS,
                  f"ddp scale {cards} cards: rank {r} (cuda:{ranks[r]['card']}) launches {got}")
        out[cards] = {"ms_per_step": ms, "pairs_per_s": cards * TRAIN_BATCH / ms * 1e3,
                      "traced_ms_per_step": t["traced_ms"], "nccl_ms_per_step": t["nccl_ms"],
                      "nccl_share": t["nccl_ms"] / t["traced_ms"], "nccl_kernels_per_step": t["nccl_kernels"],
                      "kernel_ms_per_step": t["kernel_ms"], "kernels_per_step": t["kernels"],
                      "ms": t["ms"], "peak_gib": t["peak_gib"]}
        print(f"[ddp scale] {cards} card(s), {TRAIN_BATCH} pairs of {TRAIN_H}x{TRAIN_W} a card, bf16, "
              f"bench loss stack, Adam, cross-replica BN: {ms:.2f} ms/step, "
              f"{out[cards]['pairs_per_s']:.2f} training pairs/s over {DDP_SCALE_STEPS} steps (rank 0, per "
              f"step: {', '.join(f'{v:.2f}' for v in t['ms'])} ms, the first {DDP_WARMUP} warm-ups); "
              f"traced ({DDP_TRACE_STEPS} steps, utils/profiling.py:trace): {t['traced_ms']:.2f} ms/step, "
              f"NCCL kernels {t['nccl_ms']:.3f} ms/step ({t['nccl_kernels']:.0f} a step, "
              f"{100 * out[cards]['nccl_share']:.2f}% of the step), all kernels {t['kernel_ms']:.2f} "
              f"ms/step ({t['kernels']:.0f}); corr1d and its backward once a step on cuda:"
              f"{', cuda:'.join(str(ranks[r]['card']) for r in range(cards))}; {card}", flush=True)
    print(json.dumps({"ddp_scale": {str(k): {n: v for n, v in r.items() if n != "ms"}
                                    for k, r in out.items()}}), flush=True)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--script-probe"]:  # phase 16's python, inside a launch script
        return script_probe(sys.argv[2:])
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
    ap.add_argument("--encdec", action="store_true",
                    help="only run EncoderDecoderNet and the banded forward (phase 12): each "
                         "decoder type card vs CPU, serving, training and restoring, then the "
                         "flagship in bands against its monolithic forward")
    ap.add_argument("--ddp", action="store_true",
                    help="only run phase 13 over NCCL with one rank on each visible card (two or "
                         "more), and the bf16 step at 8 pairs a card on 1, 2 and 4 cards")
    ap.add_argument("--fp32", action="store_true",
                    help="with --serve or --train: in fp32 (the CLI's default precision), with "
                         "TF32 as the program leaves it; alone: phase 14 only")
    ap.add_argument("--overfit", action="store_true",
                    help="only run the learning gate (phase 15): tools/overfit_smoke.py's "
                         "configuration, sdnet_mini in fp32 and bf16 at three seeds, the "
                         "flagship in fp32 and the label-fault control, held on the "
                         "batch-statistics mIoU and printed beside the JAX package's CPU readings")
    ap.add_argument("--scripts", action="store_true",
                    help="only run the launch scripts (phase 16): the port's train_flagship.sh "
                         "and eval_flagship.sh, unmodified, on a fixture of 256x512 pairs")
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
            or args.zoo or args.encdec or args.ddp or args.fp32 or args.overfit or args.scripts):
        precision = program_precision() if args.fp32 else contextlib.nullcontext()
        try:
            if args.ddp:
                phase_build()  # once, before any rank starts
                phase_ddp(card, nccl=True)
            elif args.encdec:
                phase_encdec(card)
            elif args.overfit:
                phase_overfit(card)
            elif args.scripts:
                phase_build()  # once, before the scripts' processes load the kernels
                phase_scripts(card)
            elif args.files:
                phase_files(card)
            elif args.zoo:
                phase_zoo(card)
            elif args.trunks:
                phase_trunks(card)
            elif args.options:
                phase_options(card)
            elif args.serve:
                with precision:
                    phase_serve(args.serve, SERVE_BATCHES, SERVE[args.serve][1], bf16=not args.fp32)
            elif args.train:
                with precision:
                    phase_train(args.train, TRAIN_WARMUP, 10, card, bf16=not args.fp32)
            elif args.fp32:
                phase_fp32(card)
            else:
                phase_backward(args.backward, None, BACKWARDS[args.backward][2][:4], autograd=False)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        sass = phase_build()
        records = {name: phase_kernel(name, sass) for name in KERNELS}
        # the fp32 forward on the main paths, each launch alone
        records["corr1d"]["fp32_main"] = corr1d_fp32_times(FP32_CORR1D_SHAPES, "[corr1d]", card)
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
        # phase 12: EncoderDecoderNet's serving and training paths launch no
        # kernel; the banded flagship launches corr1d once a forward
        paths = phase_encdec(card)
        for name in records:
            records[name]["launches_encdec"] = sum(launches[name] for path, launches in paths.items()
                                                   if path.startswith("encdec_"))
        records["corr1d"]["launches_banded_serve"] = paths["banded"]["corr1d"]
        # phase 13: two ranks on the card over gloo; corr1d's forward and
        # backward once a step in each rank's timed steps and in its CLI run
        free_card()
        launches = phase_ddp(card)
        for name in ("corr1d", "corr1d_backward"):
            records[name]["launches_ddp_train_per_rank"] = launches["train"][name]
            records[name]["launches_ddp_cli_per_rank"] = launches["cli"][name]
        # phase 14: sdnet in fp32, the CLI's default precision: corr2d once a
        # batch, corr2d and its backward once a step, and through the CLI
        paths = phase_fp32(card)
        records["corr2d"]["launches_fp32_serve"] = paths["serve"]["corr2d"]
        for name in ("corr2d", "corr2d_backward"):
            records[name]["launches_fp32_train"] = paths["train"][name]
            records[name]["launches_fp32_cli"] = paths["cli"][name]
        # phase 15: the learning gate; corr1d once a train step and once an
        # eval row, its backward once a train step (OVERFIT_LAUNCHES a run)
        paths = phase_overfit(card)
        for name in ("corr1d", "corr1d_backward"):
            records[name]["launches_overfit"] = paths["sdnet_mini"][name]
            records[name]["launches_overfit_flagship"] = paths["flagship"][name]
        # phase 16: the launch scripts, each in its own process: corr1d once a
        # train step and once an eval row, its backward once a train step
        paths = phase_scripts(card)
        for name in records:
            records[name]["launches_scripts_train"] = paths["train"][name]
            records[name]["launches_scripts_eval"] = paths["eval"][name]
        records["corr1d"]["scripts_fp32"] = paths["corr1d_fp32"]
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
