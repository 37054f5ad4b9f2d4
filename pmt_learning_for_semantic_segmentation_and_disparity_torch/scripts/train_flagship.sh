#!/usr/bin/env bash
# Canonical flagship training config (mirror of scripts/trainTorchImpl.sh:30-44)
# Usage: bash scripts/train_flagship.sh <dataset_dir> [small|full]
set -euo pipefail
DATA=${1:?dataset dir with the txt manifests}
SIZE=${2:-full}
SUFFIX=""
if [[ "$SIZE" == "small" ]]; then SUFFIX="__small"; DATA="$DATA/reduced_size"; fi
mkdir -p log
python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.cli.train \
  -net sdnet_mini_ext -backbone densenet -corrType 1dcorr \
  -crop 256 512 -b 8 -e 100 -optimType adam \
  -loss cross_entropy lovasz_loss -segWeight 1 \
  -output_activation linear -datasetName roses -train 1 \
  -colorL "$DATA/colorL_train$SUFFIX.txt" -colorR "$DATA/colorR_train$SUFFIX.txt" \
  -seg "$DATA/seg_train$SUFFIX.txt" -disp "$DATA/disp_train$SUFFIX.txt" \
  -inst "$DATA/inst_train$SUFFIX.txt" \
  -colorL_test "$DATA/colorL_val$SUFFIX.txt" -colorR_test "$DATA/colorR_val$SUFFIX.txt" \
  -seg_test "$DATA/seg_val$SUFFIX.txt" -disp_test "$DATA/disp_val$SUFFIX.txt" \
  -inst_test "$DATA/inst_val$SUFFIX.txt" \
  -w_savePath results | tee "log/train_$(date +%s).txt"
