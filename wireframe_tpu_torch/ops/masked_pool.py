"""Mask-aware pooling over the point axis (inference forward).

Port of `wireframe_tpu/ops/masked_pool.py`.  Reference semantics
(models/PointNetEncoder.py:85-111):
- validity mask: a point is valid iff |sum of its features| > 1e-9,
- masked mean: sum of valid rows / max(valid_count, 1),
- masked max: -inf fill on invalid rows, then max; non-finite results
  (all-invalid cloud) are replaced by 0.

`window_max_pool` is differentiated as the JAX package's custom VJP
(masked_pool.py:82-128): the forward saves the window argmax (the lowest
tied offset) and the backward routes each window's whole cotangent to
that row, and nothing to a fully-invalid window, instead of splitting it
among tied rows.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def point_validity_mask(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """(..., N, C) -> (..., N) bool. Matches PointNetEncoder.py:85."""
    return torch.abs(torch.sum(x, dim=-1)) > eps


def masked_mean(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over axis -2 of rows where mask is True.

    features: (..., N, C); mask: (..., N) -> (..., C).
    """
    m = mask[..., None].to(features.dtype)
    count = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    return torch.sum(features * m, dim=-2) / count


def masked_max(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over axis -2 of rows where mask is True; 0 where no row is valid."""
    filled = torch.where(mask[..., None], features,
                         torch.full_like(features, -torch.inf))
    out = torch.amax(filled, dim=-2)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def window_max_pool(features: torch.Tensor, mask: torch.Tensor,
                    window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked non-overlapping window max-pool along the point axis.

    features: (B, N, C); mask: (B, N) bool; -> ((B, ceil(N/w), C) pooled,
    (B, ceil(N/w)) bool window mask).  A window is valid iff it contains
    at least one valid point; invalid points contribute -inf to the max
    and fully-invalid windows pool to 0 (matching `masked_max`).  N is
    padded up to a multiple of `window` with invalid rows.
    """
    if window <= 1:
        return features, mask
    b, n, c = features.shape
    pad = (-n) % window
    if pad:
        features = F.pad(features, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    nw = features.shape[1] // window
    win_mask = torch.any(mask.reshape(b, nw, window), dim=2)
    pooled = _WindowMax.apply(features, mask, window, win_mask)
    return pooled, win_mask


def _window_max_fwd(features, mask, window, win_mask):
    b, n, c = features.shape
    nw = n // window
    f = features.reshape(b, nw, window, c)
    m = mask.reshape(b, nw, window)
    filled = torch.where(m[..., None], f, torch.full_like(f, -torch.inf))
    pooled = torch.amax(filled, dim=2)
    idx = torch.argmax(filled, dim=2)          # lowest tied window offset
    pooled = torch.where(win_mask[..., None], pooled,
                         torch.zeros_like(pooled))
    return pooled, idx


class _WindowMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, mask, window, win_mask):
        pooled, idx = _window_max_fwd(features, mask, window, win_mask)
        ctx.save_for_backward(idx, win_mask)
        ctx.window = window
        return pooled

    @staticmethod
    def backward(ctx, g):
        idx, win_mask = ctx.saved_tensors
        window = ctx.window
        n = idx.shape[1] * window
        # Kill cotangents of fully-invalid windows, then route each
        # window's cotangent to its argmax row.
        g = torch.where(win_mask[..., None], g, torch.zeros_like(g))
        gather = torch.repeat_interleave(g, window, dim=1)       # (B, N, C)
        idx_full = torch.repeat_interleave(idx, window, dim=1)
        offs = torch.arange(n, device=g.device) % window
        hit = idx_full == offs[None, :, None]
        df = torch.where(hit, gather, torch.zeros_like(gather))
        return df, None, None, None
