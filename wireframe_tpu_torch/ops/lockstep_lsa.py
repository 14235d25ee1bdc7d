"""K4, batched rectangular Jonker-Volgenant assignment (lockstep JV).

Port of `wireframe_tpu/ops/pallas_lsa.py`.  The wireframe loss solves one
assignment of real targets to prediction slots per sample per train step;
on the card the whole batch is one launch of the hand-written CUDA kernel
(`csrc/lockstep_lsa.cu`), so the train step needs no host round trip.  It
takes every (B, R, C) with R <= C, as the JAX kernel does: `k4_plan`
names the variant a shape runs (one warp per sample with the columns in
registers up to C = 512, a block of warps beyond) and where its costs and
state live.

- `solve_lsa_rows_lockstep_plain`: a line-for-line PyTorch copy of the
  JAX body `_lockstep_solve`: the batch advances in lockstep under masks
  and every dynamic index is a one-hot mask-and-reduce.  It is the CPU
  path and the kernel's oracle on the card.
- `solve_lsa_rows`: the wrapper.  CPU tensors take the plain version;
  CUDA tensors launch the kernel (or it raises; `ops._launch`).  Each
  launch counts "K4" and "K4 " + `k4_plan(...)["name"]`.

Ties resolve as in the JAX code: in the Dijkstra scan the lowest-index
UNASSIGNED column at the exact frontier minimum wins, otherwise the
lowest index.  Costs must be finite and non-negative, with R <= C and
`num_rows <= R`; the assignment cost is optimal (equal to scipy's).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from wireframe_tpu_torch.ops._launch import (
    SMEM_LIMIT,
    check,
    count,
    library,
    on_card,
    ptr,
)

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


# ---------------------------------------------------------------------------
# The launch plan (pure: shapes in, variant out; csrc/lockstep_lsa.cu's
# plan_for computes the same and the library is checked against it)
# ---------------------------------------------------------------------------

WARP_MAX_COLS = 32 * 16  # the warp variant's widest row: 16 columns a lane
BLOCK_COLS_PER_WARP = 256
BLOCK_MAX_WARPS = 32
BLOCK_FIXED = 2 * BLOCK_MAX_WARPS * 8 + BLOCK_MAX_WARPS * 4


def k4_plan(r: int, c: int) -> Dict:
    """What K4 launches for an (R, C) problem, from the shape alone.

    "variant": "warp" (one warp per sample, lane l owning columns l + 32 k
    for k < "cols_per_thread" in registers) up to C = 512, else "block"
    (min(32, ceil(C / 256)) warps per sample, thread t owning columns
    t + "threads" k); "costs": "shared" while the (R, C) costs fit in
    shared memory beside the block's other arrays, else "global" (each
    scan step reads its cost row from device memory); "state": where the
    column and row state live ("registers" for the warp variant; "shared"
    or, past ~12,000 columns, "global": a per-sample scratch area of
    "scratch_bytes"); "smem_bytes": the launch's dynamic shared memory;
    "name": the variant, as its launches are counted ("K4 " + name)."""
    if not 0 <= r <= c:
        raise ValueError(f"K4 needs 0 <= rows <= cols; got ({r}, {c})")
    if c <= WARP_MAX_COLS:
        cpl = next(k for k in (2, 4, 8, 16) if c <= 32 * k)
        arrays = c * 4 * 3 + r * 4 * 2
        shared = r * c * 4 + arrays <= SMEM_LIMIT
        plan = {"variant": "warp", "threads": 32, "cols_per_thread": cpl,
                "costs": "shared" if shared else "global",
                "state": "registers",
                "smem_bytes": r * c * 4 + arrays if shared else arrays,
                "scratch_bytes": 0}
    else:
        warps = min(BLOCK_MAX_WARPS, -(-c // BLOCK_COLS_PER_WARP))
        threads = 32 * warps
        state = -(-(c * 17) // 16) * 16 + r * 12
        state_shared = BLOCK_FIXED + state <= SMEM_LIMIT
        costs_shared = state_shared and (
            BLOCK_FIXED + state + r * c * 4 <= SMEM_LIMIT)
        plan = {"variant": "block", "threads": threads,
                "cols_per_thread": -(-c // threads),
                "costs": "shared" if costs_shared else "global",
                "state": "shared" if state_shared else "global",
                "smem_bytes": BLOCK_FIXED + (state if state_shared else 0)
                + (r * c * 4 if costs_shared else 0),
                "scratch_bytes": 0 if state_shared else state}
    plan["name"] = (f"{plan['variant']}, costs in {plan['costs']} memory"
                    + ("" if plan["variant"] == "warp"
                       else f", state in {plan['state']} memory"))
    return plan


# Shapes at which the library's plan is held to k4_plan when it loads:
# each variant, cost and state placement, and their edges.
_PROBES = ((40, 40), (40, 64), (40, 128), (0, 129), (256, 256), (300, 512),
           (238, 238), (239, 239), (64, 513), (64, 1024), (8, 2048),
           (1000, 1000), (16, 13000), (32, 16384))
_FIELDS = ("variant", "threads", "cols_per_thread", "costs", "state",
           "smem_bytes", "scratch_bytes")


def _c_plan(lib, r, c) -> Dict:
    raw = [lib.k4_plan(r, c, k) for k in range(len(_FIELDS))]
    block = raw[0] == 1
    return {"variant": "block" if block else "warp", "threads": raw[1],
            "cols_per_thread": raw[2],
            "costs": "shared" if raw[3] else "global",
            "state": ("shared" if raw[4] else "global") if block
            else "registers", "smem_bytes": raw[5], "scratch_bytes": raw[6]}


def _check_library(lib) -> None:
    for r, c in _PROBES:
        want = {k: k4_plan(r, c)[k] for k in _FIELDS}
        if _c_plan(lib, r, c) != want:
            raise RuntimeError(
                f"csrc/lockstep_lsa.cu plans ({r}, {c}) as "
                f"{_c_plan(lib, r, c)}; k4_plan says {want}")


def _lib():
    return library("lockstep_lsa", {"k4_lsa": "PPPPPiiiP",
                                    "k4_plan": "iii->q"}, _check_library)


def _launch(cost, num_rows, steps_out):
    _check(cost, num_rows)
    dev = cost.device
    if num_rows.device != dev:
        raise ValueError("num_rows must lie on the cost's device")
    b, r, c = cost.shape
    plan = k4_plan(r, c)
    lib = _lib()
    cost = cost.float().contiguous()
    nr = num_rows.to(torch.int32).contiguous()
    out = torch.empty((b, r), dtype=torch.int32, device=dev)
    if steps_out is not None and (steps_out.shape != (b,) or steps_out.dtype
                                  != torch.int32 or steps_out.device != dev):
        raise ValueError("steps_out must be a (B,) int32 tensor on the "
                         "cost's device")
    scratch = (torch.empty(b * plan["scratch_bytes"], dtype=torch.uint8,
                           device=dev) if plan["scratch_bytes"] else None)
    check(lib.k4_lsa(ptr(cost), ptr(nr), ptr(out), ptr(steps_out),
                     ptr(scratch), b, r, c,
                     torch.cuda.current_stream(dev).cuda_stream), "K4")
    count("K4")
    count("K4 " + plan["name"])
    return out


def solve_lsa_rows(cost: torch.Tensor, num_rows: torch.Tensor,
                   steps_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: the CUDA kernel for a CUDA cost, the plain version for a CPU
    cost.  Same contract as `solve_lsa_rows_lockstep_plain`.  On the card,
    `steps_out` ((B,) int32) optionally receives each sample's number of
    Dijkstra scan steps."""
    if not on_card(cost, "K4"):
        return solve_lsa_rows_lockstep_plain(cost, num_rows)
    return _launch(cost, num_rows, steps_out)
