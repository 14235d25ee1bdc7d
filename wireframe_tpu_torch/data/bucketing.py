"""Point-count bucketing for raw (unsampled) cloud inference.

The port's verbatim copy of `wireframe_tpu/data/bucketing.py`.

Training always samples to a fixed `num_points`, but raw Building3D
clouds span 1.3k-14k points.  Static XLA shapes mean each distinct point
count would trigger a fresh compile; bucketing bounds compilation to
len(buckets) programs: each cloud is zero-padded up to the smallest
bucket that fits (padding rows are invalid under the encoder mask and
excluded from masked pooling), and clouds larger than the biggest bucket
are randomly downsampled to it (the reference downsamples everything to
2560 unconditionally, building3d.py:128-129).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def choose_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n, else the largest bucket (cloud gets sampled)."""
    eligible = [b for b in sorted(buckets) if b >= n]
    return eligible[0] if eligible else max(buckets)


def pad_or_sample(pc: np.ndarray, bucket: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Zero-pad (or downsample without replacement) an (N, D) cloud to
    exactly `bucket` rows."""
    n = pc.shape[0]
    if n == bucket:
        return pc
    if n > bucket:
        choice = rng.choice(n, bucket, replace=False)
        return pc[choice]
    out = np.zeros((bucket, pc.shape[1]), pc.dtype)
    out[:n] = pc
    return out


def z_sort_rows(pc: np.ndarray) -> np.ndarray:
    """Stable ascending z-sort with invalid (all-zero padding) rows kept
    last — the host-side twin of the model's in-graph sort
    (DataConfig.z_sort_points).  Must run AFTER any downsampling:
    `pad_or_sample`'s rng.choice returns indices in random order, so
    sorting earlier is silently destroyed."""
    zkey = np.where(np.abs(pc.sum(-1)) > 1e-9, pc[:, 2], np.inf)
    return pc[np.argsort(zkey, kind="stable")]


def group_by_bucket(clouds: Sequence[np.ndarray],
                    buckets: Sequence[int],
                    rng: np.random.Generator,
                    z_sort: bool = False,
                    ) -> Dict[int, Tuple[List[int], np.ndarray]]:
    """Group raw clouds into per-bucket batches.

    Returns {bucket: (original_indices, stacked (K, bucket, D) array)}.
    z_sort applies `z_sort_rows` after padding/downsampling (required
    when the model was told the loader sorts, cfg.data.z_sort_points).
    """
    groups: Dict[int, List[int]] = defaultdict(list)
    for i, pc in enumerate(clouds):
        groups[choose_bucket(pc.shape[0], buckets)].append(i)
    out = {}
    for bucket, idxs in groups.items():
        rows = [pad_or_sample(np.asarray(clouds[i], np.float32), bucket, rng)
                for i in idxs]
        if z_sort:
            rows = [z_sort_rows(r) for r in rows]
        out[bucket] = (idxs, np.stack(rows))
    return out
