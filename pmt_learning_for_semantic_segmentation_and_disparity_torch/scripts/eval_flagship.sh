#!/usr/bin/env bash
# Canonical flagship eval config (mirror of scripts/evalTorchImpl.sh:31-41)
set -euo pipefail
DATA=${1:?dataset dir with the txt manifests}
CKPT=${2:?checkpoint dir}
mkdir -p testResults log
python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.cli.train \
  -net sdnet_mini_ext -backbone densenet -corrType 1dcorr \
  -crop 256 512 -b 1 -optimType adam \
  -loss cross_entropy lovasz_loss -segWeight 1 \
  -output_activation linear -datasetName roses -train 0 -show_results 1 \
  -colorL_test "$DATA/colorL_test.txt" -colorR_test "$DATA/colorR_test.txt" \
  -seg_test "$DATA/seg_test.txt" -disp_test "$DATA/disp_test.txt" \
  -inst_test "$DATA/inst_test.txt" \
  -load_weights "$CKPT" | tee "log/eval_$(date +%s).txt"
