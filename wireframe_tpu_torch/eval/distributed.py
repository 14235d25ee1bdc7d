"""The batched device Hausdorff pass of the eval paths.

Port of `batched_edge_distances` from `wireframe_tpu/eval/distributed.py`:
the pred-vs-GT segment Hausdorff matrices of a whole batch in ONE padded
device call (`hausdorff_distance_line_torch`).  The rest of that module
(shards, the cross-process counter merge) is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from wireframe_tpu_torch.metrics.hausdorff import hausdorff_distance_line_torch
from wireframe_tpu_torch.utils.platform import resolve_device


def _pad_to(k: int, mult: int = 8) -> int:
    return max(mult, ((k + mult - 1) // mult) * mult)


def batched_edge_distances(pred_evs: List[np.ndarray],
                           gt_evs: List[np.ndarray],
                           device=None) -> List[Optional[np.ndarray]]:
    """Per-sample (Qi, Ei) float64 Hausdorff matrices, computed in one
    padded float32 batch on `device` ("cuda" by default, see
    `utils.platform.resolve_device`).  Entries do not
    depend on the padding, so slicing recovers the exact per-sample
    matrices.  Samples with no predicted edges return None (the
    corners-only fallback needs no matrix).  Pads round up to multiples
    of 8, as the JAX package's do.
    """
    live = [i for i, p in enumerate(pred_evs) if len(p) > 0]
    out: List[Optional[np.ndarray]] = [None] * len(pred_evs)
    if not live:
        return out
    qm = _pad_to(max(len(pred_evs[i]) for i in live))
    em = _pad_to(max(len(gt_evs[i]) for i in live))
    pp = np.zeros((len(live), qm, 2, 3), np.float32)
    tt = np.zeros((len(live), em, 2, 3), np.float32)
    for j, i in enumerate(live):
        pp[j, :len(pred_evs[i])] = pred_evs[i]
        tt[j, :len(gt_evs[i])] = gt_evs[i]
    dev = resolve_device(device)
    with torch.inference_mode():
        d = hausdorff_distance_line_torch(
            torch.from_numpy(pp).to(dev), torch.from_numpy(tt).to(dev)
        ).cpu().numpy()
    for j, i in enumerate(live):
        out[i] = d[j, :len(pred_evs[i]), :len(gt_evs[i])].astype(np.float64)
    return out
