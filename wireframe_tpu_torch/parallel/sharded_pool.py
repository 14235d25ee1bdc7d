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

This is the explicit variant, as in the JAX package; training does not
shard the point axis (ROADMAP A7b).  The unsharded K1 call is the
reference.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from wireframe_tpu_torch.ops.fused_encoder import fused_point_encoder
from wireframe_tpu_torch.ops.masked_pool import point_validity_mask
from wireframe_tpu_torch.parallel.collective_audit import (
    all_reduce,
    group_size,
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
    import torch.distributed as dist

    n = x.shape[1]
    mp = group_size(group)
    rank = dist.get_rank(group) if mp > 1 else 0
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
