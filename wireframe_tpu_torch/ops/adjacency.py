"""Edge-prediction <-> adjacency-matrix conversions (batched, any device).

The port's copy of `wireframe_tpu/ops/adjacency.py`: capability parity
with models/utils.py:10-36 (adjacency construction and edge-label
building), on the static global pair axis (`ops/pairs.triu_pairs_on`)
with no Python loops.
"""

from __future__ import annotations

import torch

from wireframe_tpu_torch.ops.pairs import triu_pairs_on


def adjacency_from_edge_probs(edge_probs: torch.Tensor, v: int,
                              threshold: float = 0.5) -> torch.Tensor:
    """(B, E) pair probabilities -> (B, V, V) symmetric 0/1 float32
    adjacency on the probabilities' device."""
    pairs = triu_pairs_on(v, edge_probs.device)
    b = edge_probs.shape[0]
    on = (edge_probs > threshold).to(torch.float32)
    adj = torch.zeros((b, v, v), dtype=torch.float32,
                      device=edge_probs.device)
    adj[:, pairs[:, 0], pairs[:, 1]] = on
    adj[:, pairs[:, 1], pairs[:, 0]] = on
    return adj


def edge_probs_from_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """(B, V, V) adjacency -> (B, E) values on the global pair axis."""
    pairs = triu_pairs_on(adj.shape[-1], adj.device)
    return adj[:, pairs[:, 0], pairs[:, 1]]
