"""Point-axis-sharded pooling over an mp process group.

Port of `wireframe_tpu/parallel/sharded_pool.py`.  The per-point MLP is
pointwise, so the points of each cloud split freely across ranks, and
the four pooling reductions are associative: each rank encodes its
contiguous slice of the point axis and the ranks combine sums and
counts with one all-reduce SUM and the maxima with one all-reduce MAX.

Each rank's slice goes through K1 (`ops.fused_encoder.fused_point_encoder`:
the CUDA kernel on the card, its plain version on the CPU).  K1 emits
means, so a rank rebuilds its sums as mean x count (the masked mean's
count is the slice's valid rows, floored at 1 as K1 floors it; the mean's
is the slice's length).  A slice with no valid row has a masked max of 0
from K1, which would win a MAX over negative features: it enters the
reduction as -inf instead.

`sharded_point_pools` is the explicit forward-only variant, as in the
JAX package; the unsharded K1 call is its reference.
`point_pools_train` is the training variant (point-parallel training,
`models.encoder` with mp > 1): it takes the point features a rank's
training chain made of its slice and returns the four pools with
autograd through the differentiable collectives of `collective_audit`.
Each rank's maxima come from its lowest tied row (`torch.argmax` gives
the first), and `max_over_ranks` hands a maximum's gradient to the
lowest rank that holds it, so a pooled maximum's gradient reaches one
point, the lowest-indexed of the whole cloud's tied rows.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from wireframe_tpu_torch.ops.fused_encoder import fused_point_encoder
from wireframe_tpu_torch.ops.masked_pool import point_validity_mask
from wireframe_tpu_torch.parallel.collective_audit import (
    all_reduce,
    group_rank,
    group_size,
    max_over_ranks,
    sum_over_ranks,
)


def sharded_point_pools(x: torch.Tensor, stage_params: Sequence[Tuple],
                        final_w: torch.Tensor, final_b: torch.Tensor,
                        compute_dtype=torch.bfloat16, tile: int = 256,
                        group=None) -> Dict[str, torch.Tensor]:
    """The encoder's four pooled stats of `x` (B, N, D), with the point
    axis split over the ranks of `group` (the default group when None;
    without a process group, one rank holds every point).

    Every rank passes the same `x` and parameters and gets the same
    (B, C) float32 masked_mean, masked_max, mean and max.  N must divide
    by the group's size, and each slice by `tile` (K1's tiling).
    """
    n = x.shape[1]
    mp = group_size(group)
    rank = group_rank(group)
    if n % mp:
        raise ValueError(f"N={n} not divisible by mp={mp}")
    m = n // mp
    xs = x[:, rank * m:(rank + 1) * m].contiguous()
    out = fused_point_encoder(xs, stage_params, final_w, final_b, tile=tile,
                              compute_dtype=compute_dtype)
    count = torch.sum(point_validity_mask(xs.float()).float(), dim=1)
    sums = torch.stack([out["masked_mean"]
                        * torch.clamp_min(count, 1.0)[:, None],
                        out["mean"] * m,
                        count[:, None].expand_as(out["mean"])])
    maxes = torch.stack([torch.where(count[:, None] > 0, out["masked_max"],
                                     torch.full_like(out["masked_max"],
                                                     -torch.inf)),
                         out["max"]])
    all_reduce(sums, "sum", group=group)
    all_reduce(maxes, "max", group=group)
    masked_sum, total_sum, total_count = sums
    masked_max = maxes[0]
    return {
        "masked_mean": masked_sum / torch.clamp_min(total_count, 1.0),
        "masked_max": torch.where(torch.isfinite(masked_max), masked_max,
                                  torch.zeros_like(masked_max)),
        "mean": total_sum / n,
        "max": maxes[1],
    }


def _first_max(x: torch.Tensor) -> torch.Tensor:
    """The max over axis -2, differentiated into the lowest tied row."""
    idx = torch.argmax(x, dim=-2, keepdim=True)
    return torch.take_along_dim(x, idx, dim=-2).squeeze(-2)


def point_pools_train(feats: torch.Tensor, mask: torch.Tensor, n: int,
                      group=None) -> Dict[str, torch.Tensor]:
    """The four pools of a cloud whose N = `n` points are split over the
    ranks of `group` in rank order, from this rank's slice: `feats`
    (B, n / mp, C) float32 and its validity `mask` (B, n / mp).  Every
    rank gets the same (B, C) masked_mean, masked_max, mean and max, the
    one-process pools (`ops.masked_pool`) up to the summation order, with
    one SUM and two MAX all-reduces; a slice with no valid row enters the
    masked max as -inf, and a cloud with none pools to 0."""
    m = mask[..., None]
    count = torch.sum(mask.float(), dim=-1)
    sums = sum_over_ranks(torch.stack([
        torch.sum(feats * m.float(), dim=-2), torch.sum(feats, dim=-2),
        count[:, None].expand(feats.shape[0], feats.shape[-1])]), group)
    filled = torch.where(m, feats, torch.full_like(feats, -torch.inf))
    maxes = max_over_ranks(torch.stack([_first_max(filled),
                                        _first_max(feats)]), group)
    masked_max = maxes[0]
    return {
        "masked_mean": sums[0] / torch.clamp_min(sums[2], 1.0),
        "masked_max": torch.where(torch.isfinite(masked_max), masked_max,
                                  torch.zeros_like(masked_max)),
        "mean": sums[1] / n,
        "max": maxes[1],
    }
