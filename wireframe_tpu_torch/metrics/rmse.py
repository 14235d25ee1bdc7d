"""Vertex RMSE metrics.

The port's copy of `wireframe_tpu/metrics/rmse.py` (numpy and scipy only).

`hungarian_rmse` is the optimally-matched RMSE the reference defines but
never calls (models/utils.py:38-55 — quirk 5); `aligned_rmse` is the
index-aligned monitor the reference's training loop actually logs
(train.py:148-151).  Both are first-class here.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def hungarian_rmse(pred_vertices: np.ndarray,
                   true_vertices: np.ndarray) -> float:
    if len(pred_vertices) == 0 and len(true_vertices) == 0:
        return 0.0
    if len(pred_vertices) == 0 or len(true_vertices) == 0:
        return float("inf")
    diff = pred_vertices[:, None, :] - true_vertices[None, :, :]
    costs = np.sqrt(np.sum(diff * diff, axis=-1))
    pi, ti = linear_sum_assignment(costs)
    d = pred_vertices[pi] - true_vertices[ti]
    return float(np.sqrt(np.mean(d * d)))


def aligned_rmse(pred_vertices: np.ndarray,
                 true_vertices: np.ndarray) -> float:
    n = min(len(pred_vertices), len(true_vertices))
    if n == 0:
        return 0.0
    d = np.asarray(pred_vertices)[:n] - np.asarray(true_vertices)[:n]
    return float(np.sqrt(np.mean(d * d)))
