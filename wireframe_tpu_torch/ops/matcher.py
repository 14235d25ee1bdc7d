"""Public vertex-matching API.

Port of `wireframe_tpu/ops/matcher.py`: ONE batched Hungarian vertex
matcher, used standalone; the loss builds the same costs inline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from wireframe_tpu_torch.ops.lsa import solve_square


@dataclass(frozen=True)
class WireframeMatcher:
    """Hungarian vertex matcher: L1 position cost + existence costs.

    cost(pred_i, real target j)   = |p_i - t_j|_1 + (1 - e_i)
    cost(pred_i, dummy column)    = e_i

    backend: "auto" / "pallas" (the lockstep solver K4 on the square
    problem), "scipy" (host oracle); "device" (the JAX package's XLA-loop
    solver) raises NotImplementedError.
    """

    backend: str = "auto"

    def __call__(self, pred_vertices: torch.Tensor,
                 pred_existence: torch.Tensor,
                 target_vertices: torch.Tensor,
                 vertex_counts: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """
        Args:
          pred_vertices: (B, V, 3); pred_existence: (B, V) probabilities.
          target_vertices: (B, V, 3) zero-padded; vertex_counts: (B,).
        Returns:
          col4row: (B, V) int32 — target column assigned to each pred slot
            (columns >= count are dummies).
          matched: (B, V) bool — pred slot is matched to a REAL target.
        """
        from wireframe_tpu_torch.losses.wireframe_loss import (
            matching_cost_matrix,
        )

        cost = matching_cost_matrix(pred_vertices, pred_existence,
                                    target_vertices, vertex_counts)
        col4row = solve_square(cost, self.backend)
        matched = col4row < vertex_counts.to(torch.int32)[:, None]
        return col4row, matched
