"""Linear-sum-assignment helpers around K4.

Port of the host parts of `wireframe_tpu/ops/lsa.py`: the scipy oracle
(`solve_lsa_scipy`, the loss's `matcher="scipy"` path, as
`solve_lsa_callback` does it in the JAX package) and `assignment_cost`.
The JAX package's XLA-loop solver (`matcher="device"`) is not ported; its
tie-breaking can differ from the lockstep solver's, so the port raises
instead of mapping it to K4 (`solve_square`).
"""

from __future__ import annotations

import numpy as np
import torch

from wireframe_tpu_torch.ops.lockstep_lsa import solve_lsa_rows

_DEVICE_MATCHER = ("matcher='device' (the JAX package's XLA-loop JV "
                   "solver) is not ported yet: ROADMAP.md item A9.  Use "
                   "'auto' or 'pallas' (the lockstep kernel K4) or 'scipy'")


def solve_lsa_scipy(cost) -> np.ndarray:
    """Host oracle: square cost (n, n) -> col4row (n,) int32."""
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(np.asarray(cost))
    out = np.empty(np.asarray(cost).shape[0], dtype=np.int32)
    out[rows] = cols
    return out


def solve_lsa_scipy_batch(cost: torch.Tensor) -> torch.Tensor:
    """(B, n, n) -> (B, n) int32 on the cost's device, solved by scipy on
    the host from the detached cost (a device -> host round trip)."""
    c = cost.detach().float().cpu().numpy()
    out = np.stack([solve_lsa_scipy(c[i]) for i in range(c.shape[0])]) \
        if c.shape[0] else np.zeros((0, c.shape[1]), np.int32)
    return torch.from_numpy(out).to(cost.device)


def solve_square(cost: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Batched square assignment (B, n, n) -> (B, n) col4row.

    backend "auto" / "pallas": the lockstep solver K4 with every row
    active; "scipy": the host oracle; "device" raises (not ported)."""
    if backend in ("auto", "pallas"):
        b, n, _ = cost.shape
        rows = torch.full((b,), n, dtype=torch.int32, device=cost.device)
        return solve_lsa_rows(cost.detach().float(), rows)
    if backend == "scipy":
        return solve_lsa_scipy_batch(cost)
    if backend == "device":
        raise NotImplementedError(_DEVICE_MATCHER)
    raise ValueError(f"unknown matcher backend {backend!r}")


def assignment_cost(cost: torch.Tensor, col4row: torch.Tensor
                    ) -> torch.Tensor:
    """Total cost of an assignment, batched ((..., n, m), (..., n)).
    Rows with col4row == -1 contribute 0."""
    safe = torch.clamp_min(col4row, 0).long()
    picked = torch.take_along_dim(cost, safe[..., None], dim=-1)[..., 0]
    return torch.sum(torch.where(col4row >= 0, picked,
                                 torch.zeros_like(picked)), dim=-1)
