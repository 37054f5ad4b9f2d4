"""Evaluation reports (the port's copy of the JAX package's
``evaluation/evaluator.py``) — the test_model / printResultsMetrics equivalent
(torch_implementation.py:408-446, 450-582): per-step and running tabulate
tables, final mean±std summary, confusion-matrix artifacts, and EXPLICIT
(eval-only, opt-in) prediction image dumps — the reference writes jpgs from
inside its metric functions on every step (utilTorchLoss.py:267-268,
331-332); here it's a flag. The prediction dumps need cv2, imported where they run
(without it they raise naming it); the confusion heatmaps are written by the
port's own PNG codec.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

try:
    from tabulate import tabulate
except Exception:  # pragma: no cover
    tabulate = None

from ..metrics.segmetrics import mean_iou, pixel_accuracy, pixel_accuracy_class
from ..utils.viz import confusion_heatmap, write_rgb


class MetricAccumulator:
    """Collects per-step metric dicts; reports running means and mean±std."""

    def __init__(self):
        self.rows: List[Dict[str, float]] = []
        self.conf1: Optional[np.ndarray] = None
        self.conf2: Optional[np.ndarray] = None
        self._err3px_total = 0.0
        self._disp_valid_total = 0.0

    def update(self, metrics: Dict) -> Dict[str, float]:
        """Ingest one per-image metric row (one reference eval step).

        Derives the reference's max-of-heads columns: avIoU =
        max(mIoU(conf1), mIoU(conf2)) and best-head P/R/F1/BF1
        (test_model torch_implementation.py:497-511)."""
        row = {}
        confs = {}
        for k, v in metrics.items():
            if k in ("conf1", "conf2"):
                c = np.asarray(v, np.float64)
                confs[k] = c
                if k == "conf1":
                    self.conf1 = c if self.conf1 is None else self.conf1 + c
                else:
                    self.conf2 = c if self.conf2 is None else self.conf2 + c
            else:
                row[k] = float(np.asarray(v))
        if len(confs) == 2:
            miou1, _ = mean_iou(confs["conf1"])
            miou2, _ = mean_iou(confs["conf2"])
            row["av_iou"] = max(miou1, miou2)
        if "pixel_acc1" in row and "pixel_acc2" in row:
            row["pixel_acc_mean"] = (row["pixel_acc1"] + row["pixel_acc2"]) / 2
        for a, b, name in (("prec1", "prec2", "prec_best"),
                           ("recall1", "recall2", "recall_best"),
                           ("f1_1", "f1_2", "f1_best"),
                           ("bf1_1", "bf1_2", "bf1_best")):
            if a in row and b in row:
                row[name] = max(row[a], row[b])
        self._err3px_total += row.get("disp_err3px", 0.0)
        self._disp_valid_total += row.get("disp_valid", 0.0)
        self.rows.append(row)
        return row

    def running_mean(self) -> Dict[str, float]:
        if not self.rows:
            return {}
        keys = self.rows[0].keys()
        return {k: float(np.mean([r[k] for r in self.rows])) for k in keys}

    def mean_and_std(self) -> Dict[str, str]:
        """Final mean±std summary (mainAndStd, torch_implementation.py:405-406)."""
        if not self.rows:
            return {}
        keys = self.rows[0].keys()
        return {
            k: f"{np.mean([r[k] for r in self.rows]):.4f} ± "
               f"{np.std([r[k] for r in self.rows]):.4f}"
            for k in keys
        }

    def summary(self, class_names=None) -> Dict[str, float]:
        out = self.running_mean()
        if self.conf2 is not None:
            miou2, iou2 = mean_iou(self.conf2)
            miou1, _ = mean_iou(self.conf1)
            out.update(
                miou1=miou1, miou2=miou2,
                pixel_acc_cm=pixel_accuracy(self.conf2),
                pixel_acc_class=pixel_accuracy_class(self.conf2),
            )
            if class_names is not None:
                for name, v in zip(class_names, iou2):
                    out[f"iou_{name}"] = float(v)
        if self._disp_valid_total > 0:
            # pooled >3px rate — the reference's Derr / test_avgMAE2
            # (Total_MAE[2]/Total_MAE[3], torch_implementation.py:582)
            out["derr"] = self._err3px_total / self._disp_valid_total
        return out

    # -- tabulate-style reports (printResultsMetrics) ------------------------
    def table(self, step_row: Optional[Dict[str, float]] = None) -> str:
        run = self.running_mean()
        headers = sorted(run.keys())
        rows = [["running"] + [f"{run[h]:.4f}" for h in headers]]
        if step_row is not None:
            rows.insert(0, ["step"] + [f"{step_row.get(h, float('nan')):.4f}"
                                       for h in headers])
        if tabulate is None:
            return "\n".join(str(r) for r in rows)
        return tabulate(rows, headers=["" ] + headers, tablefmt="orgtbl")

    def final_table(self) -> str:
        ms = self.mean_and_std()
        rows = [[k, v] for k, v in sorted(ms.items())]
        if tabulate is None:
            return "\n".join(f"{k}: {v}" for k, v in rows)
        return tabulate(rows, headers=["metric", "mean ± std"], tablefmt="orgtbl")


def dump_prediction_images(
    out_dir: str,
    num_image: int,
    seg_logits: np.ndarray,
    seg_gt_onehot: np.ndarray,
    disp_pred: np.ndarray,
    disp_gt: np.ndarray,
):
    """Explicit eval-only image dump; layout mirrors testResults/
    (utilTorchLoss.py:267-268, 331-332): branch-channel seg maps thresholded
    at logit 0, disparity normalized against the GT range."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("prediction image dumps need cv2 (opencv-python), which is not "
                          "installed") from e
    os.makedirs(out_dir, exist_ok=True)
    pred_b = (seg_logits[0, ..., 1] > 0).astype(np.float32)
    gt_b = seg_gt_onehot[0, ..., 1]
    cv2.imwrite(os.path.join(out_dir, f"segPred_{num_image}.jpg"), pred_b * 256)
    cv2.imwrite(os.path.join(out_dir, f"segGT_{num_image}.jpg"), gt_b * 256)
    g = disp_gt[0, ..., 0]
    p = disp_pred[0, ..., 0]
    rng = max(g.max() - g.min(), 1e-8)
    cv2.imwrite(os.path.join(out_dir, f"dispGT_{num_image}.jpg"),
                (g - g.min()) / rng * 200)
    cv2.imwrite(os.path.join(out_dir, f"dispPred_{num_image}.jpg"),
                (p - g.min()) / rng * 200)


def save_confusion_matrix_png(conf: np.ndarray, class_names, path: str,
                              normalize: bool = True):
    """plot_confusion_matrix equivalent (utilTorchPlot.py:358): the
    row-normalised matrix as a ``Blues`` heatmap written by the port's PNG
    codec (``utils/viz.py:confusion_heatmap``; no matplotlib, so no axis
    labels: row i is true class ``class_names[i]``, column j predicted)."""
    cm = conf.astype(np.float64)
    if normalize:
        with np.errstate(invalid="ignore"):
            cm = cm / cm.sum(axis=1, keepdims=True)
    write_rgb(path, confusion_heatmap(cm))
