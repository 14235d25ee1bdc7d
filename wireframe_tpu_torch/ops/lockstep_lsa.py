"""K4, batched rectangular Jonker-Volgenant assignment (lockstep JV).

Port of `wireframe_tpu/ops/pallas_lsa.py`.  The wireframe loss solves one
assignment of real targets to prediction slots per sample per train step;
on the card the whole batch is one launch of the hand-written CUDA kernel
(`csrc/lockstep_lsa.cu`, one warp per sample), so the train step needs no
host round trip.

- `solve_lsa_rows_lockstep_plain`: a line-for-line PyTorch copy of the
  JAX body `_lockstep_solve`: the batch advances in lockstep under masks
  and every dynamic index is a one-hot mask-and-reduce.  It is the CPU
  path and the kernel's oracle on the card.
- `solve_lsa_rows`: the wrapper.  CPU tensors take the plain version;
  CUDA tensors launch the kernel (or it raises).  `solve_lsa_rows.launches`
  counts kernel launches.

Ties resolve as in the JAX code: in the Dijkstra scan the lowest-index
UNASSIGNED column at the exact frontier minimum wins, otherwise the
lowest index.  Costs must be finite and non-negative, with R <= C and
`num_rows <= R`; the assignment cost is optimal (equal to scipy's).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

PAD_COST = 1e9   # padded-column cost of the TPU kernel's lane padding


def max_safe_cost() -> float:
    """Callers keep real costs far below PAD_COST (the wireframe loss
    clamps its costs, NaN included, to this ceiling)."""
    return PAD_COST / 1e3


def _lockstep_solve(cost: torch.Tensor, num_rows: torch.Tensor
                    ) -> torch.Tensor:
    """cost (B, R, C) f32, num_rows (B, 1) int32 -> col4row (B, R) int32,
    -1 for rows never assigned (pallas_lsa.py:61-185)."""
    b, r, c = cost.shape
    dev = cost.device
    f32 = cost.dtype
    i32 = torch.int32
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)

    row_iota = torch.arange(r, dtype=i32, device=dev).expand(b, r)
    col_iota = torch.arange(c, dtype=i32, device=dev).expand(b, c)
    c_fill = torch.tensor(c, dtype=i32, device=dev)

    u = torch.zeros((b, r), dtype=f32, device=dev)
    v = torch.zeros((b, c), dtype=f32, device=dev)
    col4row = torch.full((b, r), -1, dtype=i32, device=dev)
    row4col = torch.full((b, c), -1, dtype=i32, device=dev)
    max_rows = int(num_rows.max()) if b else 0

    for row in range(max_rows):
        active = row < num_rows                              # (B, 1) bool
        active_f = active.to(f32)

        # ---- Dijkstra scan: run until every active sample has a sink;
        # k <= c is the NaN guard.
        SR = torch.zeros((b, r), dtype=f32, device=dev)
        SC = torch.zeros((b, c), dtype=f32, device=dev)
        spc = torch.full((b, c), float("inf"), dtype=f32, device=dev)
        path = torch.full((b, c), -1, dtype=i32, device=dev)
        minv = torch.zeros((b, 1), dtype=f32, device=dev)
        i = torch.full((b, 1), row, dtype=i32, device=dev)
        sink = torch.full((b, 1), -1, dtype=i32, device=dev)
        k = 0
        while bool(((sink < 0) & active).any()) and k <= c:
            run = (sink < 0) & active                       # (B, 1) bool
            run_f = run.to(f32)
            row_onehot_f = (row_iota == i).to(f32)          # (B, R)
            SR = torch.maximum(SR, row_onehot_f * run_f)
            cost_i = torch.sum(cost * row_onehot_f[:, :, None], dim=1)
            u_i = torch.sum(u * row_onehot_f, dim=1, keepdim=True)
            red = minv + cost_i - u_i - v                   # (B, C)
            better = (red < spc) & (SC == 0) & run
            spc = torch.where(better, red, spc)
            path = torch.where(better, i.expand(b, c), path)

            cand = torch.where(SC > 0, inf, spc)
            lowest = torch.amin(cand, dim=1, keepdim=True)
            is_low = cand == lowest
            un_low = is_low & (row4col == -1)
            j_un = torch.amin(torch.where(un_low, col_iota, c_fill),
                              dim=1, keepdim=True)
            j_any = torch.amin(torch.where(is_low, col_iota, c_fill),
                               dim=1, keepdim=True)
            j = torch.where(j_un < c, j_un, j_any)
            j = torch.clamp_max(j, c - 1)                   # NaN escape
            j_onehot_f = (col_iota == j).to(f32)
            r4c_j = torch.sum(row4col.to(f32) * j_onehot_f, dim=1,
                              keepdim=True).to(i32)
            found = (r4c_j == -1) & run
            sink = torch.where(found, j, sink)
            i = torch.where(run & ~found, r4c_j, i)
            SC = torch.maximum(SC, j_onehot_f * run_f)
            minv = torch.where(run, lowest, minv)
            k += 1
        sink = torch.clamp_min(sink, 0)                     # NaN escape

        # ---- Dual update (keeps later reduced costs non-negative).
        cur_onehot = row_iota == row
        other = (SR > 0) & ~cur_onehot
        safe_cols = torch.clamp_min(col4row, 0)             # (B, R)
        at_col = (col_iota[:, None, :] == safe_cols[:, :, None]).to(f32)
        spc_at = torch.sum(spc[:, None, :] * at_col, dim=2)  # (B, R)
        u = torch.where(active & cur_onehot, u + minv, u)
        u = torch.where(active & other, u + minv - spc_at, u)
        v = torch.where(active & (SC > 0), v - (minv - spc), v)

        # ---- Augment along predecessors from sink back to `row`.
        j = sink
        c4r, r4c = col4row, row4col
        done = 1.0 - active_f
        ka = 0
        while bool((done == 0).any()) and ka <= r:
            run_a = done == 0                               # (B, 1) bool
            j_onehot_f = (col_iota == j).to(f32)
            i_p = torch.sum(path.to(f32) * j_onehot_f, dim=1,
                            keepdim=True).to(i32)
            safe_i = torch.clamp_min(i_p, 0)                # NaN escape
            i_onehot = row_iota == safe_i
            r4c = torch.where((col_iota == j) & run_a, safe_i.expand(b, c),
                              r4c)
            nxt = torch.sum(c4r.to(f32) * i_onehot.to(f32), dim=1,
                            keepdim=True).to(i32)
            c4r = torch.where(i_onehot & run_a, j.expand(b, r), c4r)
            j = torch.where(run_a, nxt, j)
            done = torch.maximum(done, ((i_p == row) & run_a).to(f32))
            ka += 1
        col4row, row4col = c4r, r4c
    return col4row


def _check(cost: torch.Tensor, num_rows: torch.Tensor):
    if cost.dim() != 3:
        raise ValueError(f"cost must be (B, R, C), got {tuple(cost.shape)}")
    b, r, c = cost.shape
    if r > c:
        raise ValueError("need rows <= cols; transpose the problem")
    if num_rows.shape != (b,):
        raise ValueError(f"num_rows must be ({b},), got "
                         f"{tuple(num_rows.shape)}")


def solve_lsa_rows_lockstep_plain(cost: torch.Tensor,
                                  num_rows: torch.Tensor) -> torch.Tensor:
    """K4's plain version: cost (B, R, C) finite non-negative, num_rows
    (B,) active rows -> col4row (B, R) int32, -1 on inactive rows."""
    _check(cost, num_rows)
    return _lockstep_solve(cost.float(),
                           num_rows.to(torch.int32).reshape(-1, 1))


def _lib() -> ctypes.CDLL:
    from wireframe_tpu_torch.ops import _build

    lib = _build.load("lockstep_lsa")
    if not getattr(lib, "_k4_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k4_lsa.argtypes = [p, p, p, p, i, i, i, p]
        lib.k4_lsa.restype = ctypes.c_int
        lib.k4_smem_bytes.argtypes = [i, i]
        lib.k4_smem_bytes.restype = ctypes.c_size_t
        lib._k4_typed = True
    return lib


_MAX_SMEM = 227 * 1024   # shared memory one H100 block can use


def _launch(cost, num_rows, steps_out):
    _check(cost, num_rows)
    dev = cost.device
    if num_rows.device != dev:
        raise ValueError("num_rows must lie on the cost's device")
    b, r, c = cost.shape
    lib = _lib()
    if lib.k4_smem_bytes(r, c) > _MAX_SMEM:
        raise ValueError(f"K4 keeps a ({r}, {c}) problem in shared memory; "
                         f"it needs {lib.k4_smem_bytes(r, c)} bytes")
    cost = cost.float().contiguous()
    nr = num_rows.to(torch.int32).contiguous()
    out = torch.empty((b, r), dtype=torch.int32, device=dev)
    if steps_out is not None and (steps_out.shape != (b,) or steps_out.dtype
                                  != torch.int32 or steps_out.device != dev):
        raise ValueError("steps_out must be a (B,) int32 tensor on the "
                         "cost's device")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.k4_lsa(cost.data_ptr(), nr.data_ptr(), out.data_ptr(),
                     steps_out.data_ptr() if steps_out is not None else None,
                     b, r, c, stream)
    if err:
        raise RuntimeError(f"K4 launch failed: cudaError_t {err}")
    solve_lsa_rows.launches += 1
    return out


def solve_lsa_rows(cost: torch.Tensor, num_rows: torch.Tensor,
                   steps_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: the CUDA kernel for a CUDA cost, the plain version for a CPU
    cost.  Same contract as `solve_lsa_rows_lockstep_plain`.  On the card,
    `steps_out` ((B,) int32) optionally receives each sample's number of
    Dijkstra scan steps."""
    if cost.device.type == "cpu":
        return solve_lsa_rows_lockstep_plain(cost, num_rows)
    if cost.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {cost.device}")
    return _launch(cost, num_rows, steps_out)


solve_lsa_rows.launches = 0
