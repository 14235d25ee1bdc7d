"""Static vertex-pair (candidate-edge) machinery, host side.

The port's copy of the numpy parts of `wireframe_tpu/ops/pairs.py`: ONE
static lexicographic upper-triangular pair table over all
`V = max_vertices` slots, and the host-side decoders that turn per-pair
probabilities back into edge lists.  The reference's pairs over a prefix
of `c` vertices, in its loop order, are exactly the subsequence of the
global V-slot pairs whose endpoints are both `< c`, in the same order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def num_pairs(v: int) -> int:
    return v * (v - 1) // 2


@functools.lru_cache(maxsize=None)
def triu_pairs_np(v: int) -> np.ndarray:
    """(E, 2) int32 pairs (i, j), i<j, lexicographic. E = v*(v-1)/2."""
    i, j = np.triu_indices(v, k=1)
    return np.stack([i, j], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def triu_pairs_on(v: int, device: torch.device) -> torch.Tensor:
    """`triu_pairs_np(v)` as an int64 tensor on `device`, made once per
    (v, device): a table copied from the host on every forward would be a
    blocking copy each step.  Read-only; callers must not write to it.
    Made outside inference mode even when first asked for inside it, so a
    table cached while serving can still index tensors that autograd
    saves in a later train step."""
    with torch.inference_mode(False):
        return torch.as_tensor(triu_pairs_np(v), dtype=torch.long,
                               device=device)


def pair_slot(i, j, v: int):
    """Global pair-slot index of pair (i, j) with i<j over v slots.

    slot(i, j) = i*v - i*(i+1)/2 + (j - i - 1).  Works on arrays.
    """
    i = np.asarray(i, np.int32)
    j = np.asarray(j, np.int32)
    return i * v - (i * (i + 1)) // 2 + (j - i - 1)


def edge_labels_from_edges(edges: np.ndarray, v: int) -> np.ndarray:
    """(E,) float32 binary labels on the global pair axis from GT edges.

    `edges` is (n, 2) int with 0-based vertex ids (any order per row);
    self-loops and ids outside [0, v) are dropped.
    """
    labels = np.zeros(num_pairs(v), dtype=np.float32)
    if len(edges) == 0:
        return labels
    e = np.asarray(edges, dtype=np.int64)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    keep = (lo >= 0) & (hi < v) & (lo != hi)
    lo, hi = lo[keep], hi[keep]
    slots = lo * v - (lo * (lo + 1)) // 2 + (hi - lo - 1)
    labels[slots] = 1.0
    return labels


def pairs_from_mask(probs: np.ndarray, counts: int, v: int,
                    thresh: float = 0.5) -> np.ndarray:
    """Decode (E,) pair probs into an (n, 2) edge-index array, keeping
    pairs with prob > thresh and both endpoints < counts.

    Mirrors evaluate.py:80-82 on the static pair axis.
    """
    pairs = triu_pairs_np(v)
    keep = (probs > thresh) & (pairs[:, 1] < counts)
    return pairs[keep].astype(np.int64)


def pairs_from_slot_mask(probs: np.ndarray, live: np.ndarray, v: int,
                         thresh: float = 0.5) -> np.ndarray:
    """Decode for the "existence" slot-mask mode: keep pairs with
    prob > thresh whose BOTH endpoints are live per-slot (live slots are
    scattered, not a prefix)."""
    pairs = triu_pairs_np(v)
    live = np.asarray(live, bool)
    keep = (probs > thresh) & live[pairs[:, 0]] & live[pairs[:, 1]]
    return pairs[keep].astype(np.int64)
