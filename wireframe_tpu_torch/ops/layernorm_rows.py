"""The LayerNorm + ReLU of an encoder-chain stage wider than one cluster.

Part of the port of `wireframe_tpu/ops/pallas_encoder.py` (K1) and
`wireframe_tpu/ops/pallas_chain_grad.py` (K2, K3, K5).  On the card a
stage of width W <= 2048 has its LayerNorm fused into its GEMM's epilogue
across a thread-block cluster of ceil(W / 256) CTAs (`csrc/hopper_gemm.cuh`).
A cluster holds at most 8 CTAs, so a wider stage runs *split*: the GEMM
writes its f32 product (z forward, dh backward) and the row kernels of
`csrc/layernorm_rows.cu` take it from there:

- `layernorm_relu_forward`: h = relu(LayerNorm(z)) in the compute dtype
  from the f32 z, and optionally the bf16 stash of z (K2 in bf16).
- `layernorm_relu_backward`: from the stage's z (the stash, or the f32 z
  of K5's recompute) and the f32 dh: dz and optionally the rebuilt h in
  the compute dtype, and per-128-row-tile column partials of d gamma,
  d beta and d b (shape (ceil(M / 128), 3 W)), which the caller sums in
  tile order as it sums the fused epilogue's.  One launch.

Both are bound by bytes (8 B an element forward; 10 B backward in bf16,
16 B in f32), so each reads every input byte from device memory once and
moves 16 bytes at a time: rows staged in shared memory by 16-byte
`cp.async` copies in a ring, 16-byte stores, gamma and beta loaded once a
block, the backward's 128-row tile split over a thread-block cluster
whose CTAs add their column partials in rank order.  `rows_plan` names
what a call launches; rows wider than 8192 columns stream through the
same kernels in column chunks.  Every sum runs in a fixed order (no float
atomics) and the variance is centred.

Each wrapper takes its plain version (`*_plain`, the arithmetic of
`chain_grad.chain_forward_plain` / `chain_backward_plain` for one stage)
for CPU tensors and launches its kernel for CUDA tensors (`ops._launch`),
counting "LN rows fwd" / "LN rows bwd" (+ " f32"); a CUDA tensor that the
kernel does not take raises.  `hopper_gemm.chain_plan` and
`fused_encoder.k1_plan` name the stages that run split.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from wireframe_tpu_torch.ops._launch import (
    SMEM_LIMIT,
    SMS,
    aligned,
    check,
    count,
    entry,
    library,
    on_card,
    row_args,
    row_buffer,
)
from wireframe_tpu_torch.ops.hopper_gemm import KERNEL_DTYPES

ROW_TILE = 128          # rows of a backward partial (the GEMM's row tile)
LN_EPS = 1e-6
# The kernels' constants (`csrc/layernorm_rows.cu`, checked at load).
VEC = 8                 # columns a unit: 16 bytes of bf16, 32 of f32
UNITS = 2               # units a thread takes of each staged chunk
MAX_THREADS = 512       # resident rows up to VEC * UNITS * 512 = 8192
CHUNK_THREADS = 256     # wider rows: chunks of VEC * UNITS * 256 columns
MAX_RING = 4
MAX_CLUSTER = 8
RESIDENT_MAX = VEC * UNITS * MAX_THREADS
FWD_ROWS = 8            # rows a forward block takes
MAX_WARPS = MAX_THREADS // 32
# One H100 SXM, for the plan's occupancy estimate: SMS, and per SM the
# shared memory (228 KB, 1 KB of it kept per block), threads, blocks and
# registers.  Registers a thread are taken at ptxas's count rounded up:
# the backward at its launch bound's ceiling (128 at 512 threads), the
# forward at 64 (59); `ln_rows_occupancy` asks the runtime on the card.
SM_SMEM, BLOCK_RESERVED = 233472, 1024
SM_THREADS, SM_BLOCKS, SM_REGS = 2048, 32, 65536
ASSUMED_REGS = {"fwd": 64, "bwd": 128}


def _stats(z: torch.Tensor):
    mu = torch.mean(z, dim=-1, keepdim=True)
    var = torch.mean(torch.square(z - mu), dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + LN_EPS)


def layernorm_relu_forward_plain(z, gamma, beta, *, h_dtype,
                                 stash_dtype=None):
    """(h, stash): h = relu(LayerNorm(z)) in h_dtype from z (M, W) f32,
    and z in stash_dtype (None: no stash)."""
    z = z.float()
    mu, rstd = _stats(z)
    h = torch.clamp_min((z - mu) * rstd * gamma.float() + beta.float(), 0.0)
    return h.to(h_dtype), None if stash_dtype is None else z.to(stash_dtype)


def layernorm_relu_backward_plain(z, dh, gamma, beta, *, dz_dtype,
                                  rebuild_h):
    """(dz, h or None, part): the stage backward from its pre-LN z (M, W)
    and the f32 cotangent dh of its output h, with jnp.maximum's tie rule
    (half the cotangent where ln == 0); part (ceil(M / 128), 3 W) holds
    each 128-row tile's column sums of d gamma, d beta and d b."""
    z = z.float()
    dh = dh.float()
    mu, rstd = _stats(z)
    xhat = (z - mu) * rstd
    gm = gamma.float()
    ln = xhat * gm + beta.float()
    dln = torch.where(ln > 0, dh, torch.where(ln < 0, torch.zeros_like(dh),
                                              0.5 * dh))
    dxhat = dln * gm
    m1 = torch.mean(dxhat, dim=-1, keepdim=True)
    m2 = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    dz = (dxhat - m1 - xhat * m2) * rstd
    m, w = z.shape
    tiles = -(-m // ROW_TILE)
    cols = torch.cat([dln * xhat, dln, dz], dim=1)
    part = torch.zeros((tiles * ROW_TILE, 3 * w), dtype=torch.float32,
                       device=z.device)
    part[:m] = cols
    part = part.reshape(tiles, ROW_TILE, 3 * w).sum(1)
    h = torch.clamp_min(ln, 0.0).to(dz_dtype) if rebuild_h else None
    return dz.to(dz_dtype), h, part


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

def smem_bytes(direction: str, z_size: int, threads: int, ring: int,
               rows: int, w: int) -> int:
    """Dynamic shared memory of one block, as `csrc/layernorm_rows.cu`'s
    `layout` places it: gamma | beta (resident rows), the ring of `ring`
    slots (a slot: the stage's z and, backward, its f32 dh), the
    backward's column-partial exchange (3 chunk floats, on the ring's
    bytes when resident), the backward's per-row statistics (column
    chunks) and the block sums' scratch."""
    bwd = direction == "bwd"
    chunk = VEC * UNITS * threads
    resident = w <= chunk
    slot = chunk * (z_size + 4 if bwd else 4)
    ring_b, part_b = ring * slot, 3 * chunk * 4 if bwd else 0
    out = 2 * chunk * 4 if resident else 0
    out += max(ring_b, part_b) if resident else ring_b + part_b
    if bwd and not resident:
        out += rows * 16
    return out + 2 * MAX_WARPS * 2 * 4


def rows_plan(m: int, w: int, dtype, direction: str,
              z_dtype=None) -> Dict:
    """What one row-kernel call launches for (M, W) in compute dtype
    `dtype` (bf16 or f32), `direction` "fwd" or "bwd", from the shape
    alone.  `z_dtype` is the backward's z (default: the bf16 stash in
    bf16, the f32 z in f32).

    "mode": "registers" (forward) or "shared memory" (backward) while a
    whole row fits one stage (W <= 8192): it comes from device memory
    once and is reduced where the mode says; "column chunks" beyond,
    streaming chunks of "chunk_cols" columns (forward: each row read
    twice; backward: z three times, dh twice).  "threads" a block (each
    thread "units" units of 8 columns a stage), "rows_per_cta",
    "rows_per_stage" (1), "ring" (stages in shared memory; the deepest
    that keeps "ctas_per_sm" at its best), "cluster" (backward: the CTAs
    of one 128-row tile), "grid" (CTAs), "smem_bytes" (dynamic shared
    memory), "ctas_per_sm" (estimated from shared memory, threads and
    assumed registers) and "waves" (grid over 132 SMs at that count);
    backward also "part", the column partials' shape."""
    if m < 1 or w < 1:
        raise ValueError(f"the row kernels need M, W >= 1; got ({m}, {w})")
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction is 'fwd' or 'bwd', not {direction!r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the row kernels compute in bf16 or f32, not "
                         f"{dtype}")
    bwd = direction == "bwd"
    if z_dtype is None:
        z_dtype = dtype
    if bwd and z_dtype not in (torch.bfloat16, torch.float32) or (
            bwd and dtype == torch.float32 and z_dtype != torch.float32):
        raise ValueError(f"the backward reads a bf16 or f32 z (f32 for f32 "
                         f"dz); got {z_dtype} for {dtype}")
    z_size = 2 if bwd and z_dtype == torch.bfloat16 else 4
    if w <= RESIDENT_MAX:
        threads = 32 * -(-w // (32 * VEC * UNITS))
        mode = "shared memory" if bwd else "registers"
    else:
        threads = CHUNK_THREADS
        mode = "column chunks"
    chunk = VEC * UNITS * threads
    cluster = MAX_CLUSTER if bwd else 1
    rows = ROW_TILE // cluster if bwd else FWD_ROWS
    best = None
    for ring in range(2, MAX_RING + 1):
        smem = smem_bytes(direction, z_size, threads, ring, rows, w)
        if smem > SMEM_LIMIT:
            break
        per_sm = min(SM_THREADS // threads, SM_BLOCKS,
                     SM_SMEM // (smem + BLOCK_RESERVED),
                     SM_REGS // (threads * ASSUMED_REGS[direction]))
        if best is None or per_sm >= best[2]:
            best = (ring, smem, per_sm)
    ring, smem, per_sm = best
    grid = cluster * -(-m // ROW_TILE) if bwd else -(-m // rows)
    plan = {"direction": direction, "mode": mode, "threads": threads,
            "units": UNITS, "unit_cols": VEC, "chunk_cols": chunk,
            "chunks": -(-w // chunk), "rows_per_cta": rows,
            "rows_per_stage": 1, "ring": ring, "cluster": cluster,
            "grid": grid, "smem_bytes": smem, "ctas_per_sm": per_sm,
            "waves": grid / (SMS * per_sm)}
    if bwd:
        plan["part"] = (-(-m // ROW_TILE), 3 * w)
    return plan


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# The library's constants (`ln_rows_const`) and the plans at which its
# shared-memory layout is held to `smem_bytes` when it loads.
_CONSTS = (ROW_TILE, VEC, UNITS, MAX_THREADS, CHUNK_THREADS, MAX_RING,
           MAX_CLUSTER, SMEM_LIMIT)
_PROBE_WIDTHS = (2049, 2304, 4096, 4100, 8192, 8193, 12288, 65536)


_SIGNATURES = {"ln_rows_fwd": "PiPPPiPiiiiiiiP",
               "ln_rows_fwd_f32": "PiPPPiPiiiiiiiP",
               "ln_rows_bwd": "PiiPiPPPiPiPiiiiiiiP",
               "ln_rows_bwd_f32": "PiiPiPPPiPiPiiiiiiiP",
               "ln_rows_const": "i", "ln_rows_smem": "iiiiii",
               "ln_rows_occupancy": "iiiiiii"}
KERNEL = "the LayerNorm row kernel"


def _check_library(lib) -> None:
    got = tuple(lib.ln_rows_const(k) for k in range(len(_CONSTS)))
    if got != _CONSTS:
        raise RuntimeError(f"csrc/layernorm_rows.cu's constants {got} "
                           f"are not ops/layernorm_rows.py's {_CONSTS}")
    for w in _PROBE_WIDTHS:
        for dt, direction, zdt in (
                (torch.bfloat16, "fwd", None),
                (torch.float32, "fwd", None),
                (torch.bfloat16, "bwd", torch.bfloat16),
                (torch.bfloat16, "bwd", torch.float32),
                (torch.float32, "bwd", torch.float32)):
            pl = rows_plan(20480, w, dt, direction, zdt)
            zs = 2 if zdt == torch.bfloat16 else 4
            c_smem = lib.ln_rows_smem(
                int(direction == "bwd"), zs, pl["threads"], pl["ring"],
                pl["rows_per_cta"], w)
            if c_smem != pl["smem_bytes"]:
                raise RuntimeError(
                    f"csrc/layernorm_rows.cu lays out {c_smem} bytes of "
                    f"shared memory for {direction} W={w}; rows_plan "
                    f"says {pl['smem_bytes']}")


def _lib():
    return library("layernorm_rows", _SIGNATURES, _check_library)


def occupancy(plan: Dict, dtype, z_dtype=None) -> int:
    """What the runtime on the card says fits at once for `plan`: forward
    blocks per SM, or backward clusters on the card."""
    bwd = plan["direction"] == "bwd"
    z32 = (z_dtype or dtype) == torch.float32
    m = plan["part"][0] * ROW_TILE if bwd else 1
    return _lib().ln_rows_occupancy(
        int(bwd), int(dtype == torch.float32), int(z32), m,
        plan["threads"], plan["cluster"], plan["smem_bytes"])


def _check_rows(what, t, m, w, dtypes):
    if (t.dim() != 2 or tuple(t.shape) != (m, w) or t.stride(1) != 1
            or t.dtype not in dtypes):
        raise ValueError(f"{what} must be an ({m}, {w}) row-major "
                         f"{'/'.join(map(str, dtypes))} array, got "
                         f"{t.dtype} {tuple(t.shape)} {t.stride()}")


def _params(gamma, beta, w, dev):
    for t in (gamma, beta):
        if t.shape != (w,) or t.device != dev:
            raise ValueError(f"LayerNorm terms must be ({w},) on {dev}")
    return [aligned(t, torch.float32) for t in (gamma, beta)]


def layernorm_relu_forward(z: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, *, h_dtype,
                           stash_dtype=None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The split stage's forward: the CUDA kernel for a CUDA z, the plain
    version for a CPU z.  z (M, W) f32 with unit column stride; h_dtype
    bf16 or f32; stash_dtype None or, with bf16 h, bf16.  On the card h
    and the stash have rows a multiple of 8 elements apart."""
    if not on_card(z, "the LayerNorm rows forward"):
        return layernorm_relu_forward_plain(z, gamma, beta, h_dtype=h_dtype,
                                            stash_dtype=stash_dtype)
    m, w = z.shape
    _check_rows("z", z, m, w, (torch.float32,))
    if h_dtype not in KERNEL_DTYPES or stash_dtype not in (
            None, torch.bfloat16) or (stash_dtype is not None
                                      and h_dtype != torch.bfloat16):
        raise ValueError(f"h in bf16 or f32 and a bf16 stash only beside "
                         f"bf16 h; got {h_dtype}, {stash_dtype}")
    dev = z.device
    g, b = _params(gamma, beta, w, dev)
    zp = row_args("z", z, KERNEL)
    h = row_buffer(m, w, h_dtype, dev)
    stash = (None if stash_dtype is None
             else row_buffer(m, w, stash_dtype, dev))
    plan = rows_plan(m, w, h_dtype, "fwd")
    check(entry(_lib(), "ln_rows_fwd", h_dtype)(
        *zp, g.data_ptr(), b.data_ptr(), *row_args("h", h, KERNEL),
        *row_args("stash", stash, KERNEL), m, w, plan["threads"],
        plan["rows_per_cta"], plan["ring"], plan["smem_bytes"],
        torch.cuda.current_stream(dev).cuda_stream), "LayerNorm rows forward")
    count("LN rows fwd", h_dtype)
    return h, stash


def layernorm_relu_backward(z: torch.Tensor, dh: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor, *,
                            dz_dtype, rebuild_h: bool):
    """The split stage's backward: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  z (M, W): the bf16 stash (with bf16
    dz) or the f32 z; dh (M, W) f32.  Returns (dz, h or None, part); on
    the card dz and h have rows a multiple of 8 elements apart."""
    if not on_card(z, "the LayerNorm rows backward"):
        return layernorm_relu_backward_plain(z, dh, gamma, beta,
                                             dz_dtype=dz_dtype,
                                             rebuild_h=rebuild_h)
    m, w = z.shape
    _check_rows("z", z, m, w, KERNEL_DTYPES)
    _check_rows("dh", dh, m, w, (torch.float32,))
    if dz_dtype not in KERNEL_DTYPES or (
            dz_dtype == torch.float32 and z.dtype != torch.float32):
        raise ValueError(f"dz in bf16 or f32, and an f32 z for f32 dz; got "
                         f"{dz_dtype} from a {z.dtype} z")
    dev = z.device
    if dh.device != dev:
        raise ValueError("dh must lie on z's device")
    g, b = _params(gamma, beta, w, dev)
    zp, dhp = row_args("z", z, KERNEL), row_args("dh", dh, KERNEL)
    dz = row_buffer(m, w, dz_dtype, dev)
    h = row_buffer(m, w, dz_dtype, dev) if rebuild_h else None
    plan = rows_plan(m, w, dz_dtype, "bwd", z.dtype)
    part = torch.empty(plan["part"], dtype=torch.float32, device=dev)
    check(entry(_lib(), "ln_rows_bwd", dz_dtype)(
        zp[0], zp[1], int(z.dtype == torch.float32), *dhp, g.data_ptr(),
        b.data_ptr(), *row_args("dz", dz, KERNEL),
        *row_args("h", h, KERNEL), part.data_ptr(), m, w, plan["threads"],
        plan["rows_per_cta"], plan["ring"], plan["cluster"],
        plan["smem_bytes"],
        torch.cuda.current_stream(dev).cuda_stream), "LayerNorm rows backward")
    count("LN rows bwd", dz_dtype)
    return dz, h, part
