"""Dataset / model analysis tooling: the port's copy of the JAX package's
``utils/analysis.py``, run over the port's datasets (``StereoSegDataset.
load_raw``).

Mirror of util/utilTorchAnalysis.py: channel mean/std (computeMeanStd :11),
disparity statistics (:63), per-class pixel statistics (:214, :357), loader
smoke checks (:91), disparity inversion check (:478). Host-side numpy with a
thread pool replacing joblib.
"""
from __future__ import annotations

import concurrent.futures as futures
from typing import Dict, Sequence, Tuple

import numpy as np


def compute_mean_std(dataset, max_samples: int = 200) -> Dict[str, np.ndarray]:
    """Channel-wise mean/std over the (normalized) left images."""
    n = min(len(dataset), max_samples)
    s = np.zeros(3)
    s2 = np.zeros(3)
    count = 0
    for i in range(n):
        img = dataset.load_raw(i)["left"].astype(np.float64) / 255.0
        s += img.reshape(-1, 3).sum(0)
        s2 += (img.reshape(-1, 3) ** 2).sum(0)
        count += img.shape[0] * img.shape[1]
    mean = s / count
    std = np.sqrt(np.maximum(s2 / count - mean**2, 0))
    return {"mean": mean, "std": std}


def compute_disp_stats(dataset, max_samples: int = 200) -> Dict[str, float]:
    """Disparity histogram stats (utilTorchAnalysis.py:63)."""
    vals = []
    for i in range(min(len(dataset), max_samples)):
        d = dataset.load_raw(i)["disp"]
        vals.append(d[d > 0])
    v = np.concatenate(vals) if vals else np.zeros(1)
    return {
        "min": float(v.min()), "max": float(v.max()),
        "mean": float(v.mean()), "p50": float(np.median(v)),
        "p99": float(np.percentile(v, 99)),
    }


def count_classes_in_dataset(
    dataset, n_labels: int, min_pxl: int = 0, workers: int = 16,
    max_samples=None,
) -> np.ndarray:
    """Per-image class occurrence matrix (getDatasetStats,
    utilTorchAnalysis.py:214-238 — joblib -> thread pool)."""
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)

    def one(i):
        seg = dataset.load_raw(i)["seg"]
        return (seg.reshape(-1, seg.shape[-1]).sum(0) > min_pxl).astype(np.int64)

    with futures.ThreadPoolExecutor(workers) as pool:
        rows = list(pool.map(one, range(n)))
    return np.stack(rows)


def class_occurrence_csv(dataset, n_labels: int, path: str, workers: int = 16):
    """Write the per-image class-occurrence CSV consumed by the
    class-balanced sampler (utilTorchDataLoader.py:60-70)."""
    import pandas as pd

    mat = count_classes_in_dataset(dataset, n_labels, workers=workers)
    df = pd.DataFrame(mat, columns=[str(c) for c in range(mat.shape[1])])
    df.insert(0, "n", np.arange(len(df)))
    df.to_csv(path, index=False)
    return path


def check_disparity_inversion(dataset, max_samples: int = 20) -> bool:
    """invertDisp sanity: ROSeS disp must be finite, nonnegative
    (utilTorchAnalysis.py:478)."""
    for i in range(min(len(dataset), max_samples)):
        d = dataset.load_raw(i)["disp"]
        if not np.isfinite(d).all() or (d < 0).any():
            return False
    return True
