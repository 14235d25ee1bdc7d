"""Segment-to-segment Hausdorff distance (sampled).

Port of `wireframe_tpu/metrics/hausdorff.py`.  Semantics of
eval/ap_calculator.py:8-36: each 3D segment is discretized into
`sample_points` equally spaced points (endpoints included); the distance
between two segments is the symmetric Hausdorff distance between their
point sets; returns the full N x M matrix.

Two implementations:
- numpy, float64 (the host eval path, mirrors the reference numerically);
- torch, float32 (`hausdorff_distance_line_torch`, the twin of the JAX
  package's `hausdorff_distance_line_jax`, used by the device eval paths).
  Its sample weights are `linspace_f32`, the JAX package's f32 linspace
  bit for bit (torch.linspace differs in the last bit of some entries),
  and every entry is computed elementwise in one fixed order (squared
  distance as dx*dx + dy*dy + dz*dz, then sqrt, then exact min / max),
  so an entry does not depend on the padding or the batch shape around
  it: the padded batch of `eval.distributed.batched_edge_distances` and
  the fixed (qmax, emax) blocks of `eval.pipeline` give the same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _sample_segments_np(lines: np.ndarray, s: int) -> np.ndarray:
    # lines: (K, 2, 3) -> (K, S, 3)
    w = np.linspace(0.0, 1.0, s).reshape(1, s, 1)
    a = lines[:, 0, :][:, None, :]
    b = lines[:, 1, :][:, None, :]
    return a + w * (b - a)


def hausdorff_distance_line(p_line: np.ndarray, t_line: np.ndarray,
                            sample_points: int = 20) -> np.ndarray:
    """(N,2,3) x (M,2,3) -> (N,M) symmetric Hausdorff matrix (numpy)."""
    p_line = np.asarray(p_line, dtype=np.float64)
    t_line = np.asarray(t_line, dtype=np.float64)
    n, m = p_line.shape[0], t_line.shape[0]
    if n == 0:
        return np.array([])
    ps = _sample_segments_np(p_line, sample_points)  # (N, S, 3)
    ts = _sample_segments_np(t_line, sample_points)  # (M, S, 3)
    # (N, M, S, S) pairwise point distances
    diff = ps[:, None, :, None, :] - ts[None, :, None, :, :]
    d = np.sqrt(np.sum(diff * diff, axis=-1))
    h_pt = d.min(axis=3).max(axis=2)  # sup_p inf_t
    h_tp = d.min(axis=2).max(axis=2)  # sup_t inf_p
    return np.maximum(h_pt, h_tp)


@functools.lru_cache(maxsize=None)
def linspace_f32(s: int) -> np.ndarray:
    """(s,) float32 weights 0 .. 1 as `jnp.linspace(0.0, 1.0, s)` computes
    them: iota / (s - 1) in float32, the endpoint set to 1.  Read-only."""
    if s < 2:
        out = np.zeros(s, np.float32)
    else:
        div = np.float32(s - 1)
        out = np.append(np.arange(s - 1, dtype=np.float32) / div,
                        np.float32(1.0))
    out.setflags(write=False)
    return out


def hausdorff_distance_line_torch(p_line: torch.Tensor, t_line: torch.Tensor,
                                  sample_points: int = 20) -> torch.Tensor:
    """(..., N, 2, 3) x (..., M, 2, 3) float32 -> (..., N, M) symmetric
    Hausdorff matrices on the tensors' device (leading dims broadcast)."""
    w = torch.from_numpy(linspace_f32(sample_points).copy()).to(
        device=p_line.device)[:, None]                        # (S, 1)

    def sample(lines):                                        # (..., K, S, 3)
        a, b = lines[..., 0:1, :], lines[..., 1:2, :]
        return a + w * (b - a)

    ps, ts = sample(p_line), sample(t_line)
    # (..., N, M, S, S) squared distances, one coordinate at a time:
    # dx*dx + dy*dy + dz*dz, never a reduction whose order may change.
    sq = None
    for c in range(3):
        dc = (ps[..., :, None, :, None, c] - ts[..., None, :, None, :, c])
        dc = dc.mul_(dc)
        sq = dc if sq is None else sq.add_(dc)
    d = sq.sqrt_()
    h_pt = d.amin(dim=-1).amax(dim=-1)   # sup_p inf_t
    h_tp = d.amin(dim=-2).amax(dim=-1)   # sup_t inf_p
    return torch.maximum(h_pt, h_tp)
