"""Hungarian-matched wireframe loss, fully batched, on the device.

Port of `wireframe_tpu/losses/wireframe_loss.py`:

1. Vertex position loss: Smooth-L1 over Hungarian-matched (pred, target)
   vertex pairs, as the sum of matched coordinates' Smooth-L1 over
   3 * total_matches.  The square problem (real targets + p_i-valued
   dummy columns) is solved as the rectangular c x V problem of real
   targets to prediction slots with cost L1(i, j) + 2 - 2 p_i, by the
   lockstep solver K4 (`ops.lockstep_lsa.solve_lsa_rows`).
2. Existence loss: BCE over all (B, V) slots against the prefix labels,
   or against "matched to a real target" (`matched_existence_labels`).
3. Edge loss: BCE over candidate pairs, masked sum over
   B * max_b C(count_b, 2) (the reference's padded-mean denominator);
   with `matched_edge_labels` the labels are permuted through the
   matching and only pairs of two matched slots count.

total = vertex_weight * (1) + existence_weight * (2) + edge_weight * (3).

matcher: "auto" and "pallas" take K4; "scipy" detaches the square cost
and solves it on the host; "device" (the JAX package's XLA-loop solver)
raises NotImplementedError.  No path syncs with the host except "scipy".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from wireframe_tpu_torch.ops.lockstep_lsa import max_safe_cost, solve_lsa_rows
from wireframe_tpu_torch.ops.lsa import _DEVICE_MATCHER, solve_lsa_scipy_batch
from wireframe_tpu_torch.ops.pairs import triu_pairs_on


@dataclass(frozen=True)
class WireframeLossConfig:
    vertex_weight: float = 3.0
    edge_weight: float = 1.0
    existence_weight: float = 1.5
    matcher: str = "auto"
    matched_edge_labels: bool = False
    matched_existence_labels: bool = False


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise Smooth-L1 (huber, beta=1)."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise binary cross-entropy from logits (stable)."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def matching_cost_matrix(pred_vertices: torch.Tensor,
                         pred_existence: torch.Tensor,
                         target_vertices: torch.Tensor,
                         vertex_counts: torch.Tensor) -> torch.Tensor:
    """Batched (B, V, V) assignment cost: columns j < count are real
    targets (L1 + |p - 1|), columns j >= count dummies (cost p)."""
    v = pred_vertices.shape[1]
    l1 = torch.sum(torch.abs(pred_vertices[:, :, None, :]
                             - target_vertices[:, None, :, :]), dim=-1)
    p = pred_existence[:, :, None]
    cost_real = l1 + torch.abs(p - 1.0)
    cost_dummy = p.expand_as(l1)
    col_is_real = (torch.arange(v, dtype=torch.int32,
                                device=l1.device)[None, None, :]
                   < vertex_counts.to(torch.int32)[:, None, None])
    return torch.where(col_is_real, cost_real, cost_dummy)


def _matched_cols(pred_v, pred_p, tgt_v, counts, matcher: str):
    """col4row (B, V): the target index matched to each prediction slot,
    or a >= count sentinel for an unmatched slot."""
    b, v, _ = pred_v.shape
    if matcher == "scipy":
        # The detach mirrors the reference's .detach() before scipy.
        return solve_lsa_scipy_batch(
            matching_cost_matrix(pred_v, pred_p, tgt_v, counts))
    if matcher == "device":
        raise NotImplementedError(_DEVICE_MATCHER)
    if matcher not in ("auto", "pallas"):
        raise ValueError(f"unknown matcher {matcher!r}")
    with torch.no_grad():
        l1 = torch.sum(torch.abs(pred_v[:, :, None, :] - tgt_v[:, None, :, :]),
                       dim=-1)                              # (B, Vpred, Vtgt)
        cost_t = l1.transpose(1, 2) + (2.0 - 2.0 * pred_p)[:, None, :]
        # The solver's padded-column contract: clamp to the safe ceiling
        # and map NaN there too (wireframe_loss.py:150-154).
        ceil = max_safe_cost()
        cost_t = torch.where(torch.isnan(cost_t),
                             torch.full_like(cost_t, ceil),
                             torch.clamp_max(cost_t, ceil))
        slot4target = solve_lsa_rows(cost_t.contiguous(), counts)
        # Invert target -> slot into the square-problem convention.
        # A -1 slot (the solver's NaN escape) lands on the sentinel, as a
        # negative index does in the JAX scatter.
        tgt_idx = torch.arange(v, dtype=torch.int32, device=pred_v.device)
        idx = torch.where((tgt_idx[None, :] < counts[:, None])
                          & (slot4target >= 0), slot4target,
                          torch.full_like(slot4target, v))
        out = torch.full((b, v + 1), v, dtype=torch.int32,
                         device=pred_v.device)
        out.scatter_(1, idx.long(), tgt_idx.expand(b, v).contiguous())
        return out[:, :v]


def wireframe_loss(predictions: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor],
                   cfg: WireframeLossConfig = WireframeLossConfig()
                   ) -> Dict[str, torch.Tensor]:
    """
    predictions: vertices (B,V,3), existence_logits (B,V),
      existence_probabilities (B,V), edge_logits (B,E), pair_mask (B,E).
    targets: vertices (B,V,3) zero-padded, vertex_existence (B,V),
      edge_labels (B,E) on the global pair axis, vertex_counts (B,).
    """
    pred_v = predictions["vertices"]
    pred_p = predictions["existence_probabilities"]
    tgt_v = targets["vertices"]
    counts = targets["vertex_counts"].to(torch.int32)
    b, v, _ = pred_v.shape
    dev = pred_v.device

    # ---- 1. Hungarian-matched vertex loss --------------------------------
    col4row = _matched_cols(pred_v, pred_p, tgt_v, counts, cfg.matcher)
    matched = col4row < counts[:, None]                        # (B, V)
    safe = torch.where(matched, col4row, torch.zeros_like(col4row)).long()
    tgt_matched = torch.take_along_dim(tgt_v, safe[..., None], dim=1)
    per_coord = smooth_l1(pred_v - tgt_matched)
    per_coord = per_coord * matched[..., None].to(per_coord.dtype)
    total_matches = torch.sum(matched.to(torch.float32))
    vertex_loss = torch.where(
        total_matches > 0,
        torch.sum(per_coord) / (3.0 * torch.clamp_min(total_matches, 1.0)),
        torch.zeros((), dtype=per_coord.dtype, device=dev))

    # ---- 2. Vertex existence BCE -----------------------------------------
    if cfg.matched_existence_labels:
        existence_labels = matched.to(torch.float32)
    else:
        existence_labels = targets["vertex_existence"].to(torch.float32)
    existence_loss = torch.mean(
        bce_with_logits(predictions["existence_logits"], existence_labels))

    # ---- 3. Edge BCE (reference padded-mean semantics) --------------------
    edge_labels = targets["edge_labels"].to(torch.float32)
    pair_mask = predictions["pair_mask"].to(torch.float32)
    if cfg.matched_edge_labels:
        # Supervise pair (i, j) of prediction slots with the GT edge
        # between their matched targets.
        pairs = triu_pairs_on(v, dev)
        pi, pj = pairs[:, 0], pairs[:, 1]
        adj = torch.zeros((b, v, v), dtype=torch.float32, device=dev)
        adj[:, pi, pj] = edge_labels
        adj = adj + adj.transpose(1, 2)
        ti = safe[:, pi]
        tj = safe[:, pj]
        edge_labels = adj[torch.arange(b, device=dev)[:, None], ti, tj]
        pair_mask = (matched[:, pi] & matched[:, pj]).to(torch.float32)
        edge_labels = edge_labels * pair_mask
    edge_bce = bce_with_logits(predictions["edge_logits"], edge_labels)
    masked_sum = torch.sum(edge_bce * pair_mask)
    max_pairs = torch.amax(counts * (counts - 1) // 2).to(torch.float32)
    denom = torch.clamp_min(b * max_pairs, 1.0)
    edge_loss = torch.where(max_pairs > 0, masked_sum / denom,
                            torch.zeros((), dtype=masked_sum.dtype,
                                        device=dev))

    total = (cfg.vertex_weight * vertex_loss
             + cfg.existence_weight * existence_loss
             + cfg.edge_weight * edge_loss)
    return {
        "total_loss": total,
        "vertex_loss": vertex_loss,
        "existence_loss": existence_loss,
        "edge_loss": edge_loss,
        "matched_cols": col4row,
        "edge_labels_eff": edge_labels,
        "pair_mask_eff": pair_mask,
    }
