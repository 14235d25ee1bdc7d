"""K2 + K3 + K5, the differentiable point chain of the training step.

Port of `wireframe_tpu/ops/pallas_chain_grad.py`: the per-point MLP
(Linear + LayerNorm + ReLU per stage, plain Linear projection) as a
`torch.autograd.Function`.  With `backward="stash"` its

- forward is **K2** (`_chain_forward_stash_pallas`): the chain, with each
  stage's pre-LayerNorm activation z_k stored in the compute dtype and,
  with kv_pool = p > 1, the masked window max / int32 argmax / masked
  window sum of the features over p consecutive rows (`_kv_pool_tile_fwd`);
- backward is **K3** (`_chain_backward_pallas` with zs): the kv cotangent
  scatter (`_kv_pool_tile_bwd`), the LayerNorm statistics rebuilt from the
  stored z (`_stages_from_z`), then per stage the ReLU backward with
  `jnp.maximum`'s tie rule (half the cotangent where ln == 0 exactly), the
  LayerNorm backward, dW = h^T dz and dh = dz W^T, in f32.

With `backward="remat"` (the config default) it is **K5**: the forward
(`_chain_forward_pallas`) is K2 without the stash, and the Function saves
only x, the parameters and, with kv_pool, the argmax; the backward
(`_chain_backward_pallas` with zs=None) recomputes every stage's z in f32
and the LayerNorm statistics from that f32 z (`_recompute_stages`), then
runs K3's stage backward.  The Pallas kernel recomputes per tile in VMEM
and holds nothing more; on the card K5 recomputes chunk by chunk of rows
(`remat_plan`: at most REMAT_CHUNK_BYTES a chunk, one chunk up to
(8, 2560) of the shipped encoder), so its transient does not grow with
the batch (`tests/test_torch_remat_chunks.py`; `chip_smoke.py`'s
`k5_bwd_peak` measures it on the card).

Three flavours, as `make_differentiable_chain`:
  kv_pool = 0                      -> features (B, N, C)
  kv_pool > 1, emit_features       -> (features, pooled, sums)
  kv_pool > 1, not emit_features   -> (pooled, sums)   [the recipe]

Each kernel has its plain PyTorch version here (`chain_forward_plain`,
`chain_backward_plain`, the arithmetic written out, not autograd; zs=None
is the remat backward); the wrappers `chain_forward` / `chain_backward`
(K2 / K3) and `remat_chain_forward` / `remat_chain_backward` (K5) take it
for CPU tensors and launch the CUDA kernels (`csrc/chain_grad.cu`) for
CUDA tensors (`ops._launch`), each call counting "K2", "K3", "K5 fwd" or
"K5 bwd" (+ " f32").  The kernels compute in the JAX kernels' two dtypes
(`hopper_gemm.kernel_dtype`): bf16 operands on the wgmma main loop, or
f32 operands, h, stash and dz on a 3xTF32 wgmma main loop (each operand
split into TF32 hi + lo, hi*hi + hi*lo + lo*hi summed in f32:
f32-accurate; `hopper_gemm.chain_plan` says which).  A stage of width <=
2048 runs its LayerNorm in its GEMM's epilogue across a cluster of
ceil(W / 256) CTAs; a wider stage runs split (the GEMM writes its f32
product, `ops.layernorm_rows` the LayerNorm): every width runs.
Products of `compute_dtype` operands with f32 accumulation are written as
f32 products of rounded operands (exact products, f32 sums), as in
`ops.fused_encoder`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from wireframe_tpu_torch.ops._launch import (
    SMS,
    check,
    count,
    entry,
    library,
    on_card,
    pad8,
    ptr,
    row_buffer,
    tma_rows,
)
from wireframe_tpu_torch.ops.fused_encoder import dot, ln
from wireframe_tpu_torch.ops.hopper_gemm import (
    BK,
    BK_F32,
    BM,
    BN,
    MAX_CLUSTER,
    chain_plan,
    gemm_operands,
    kernel_dtype,
    smem_bytes,
    split_k,
    stage_mode,
)
from wireframe_tpu_torch.ops.layernorm_rows import (
    layernorm_relu_backward,
    layernorm_relu_forward,
)

def _valid_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, N, D) -> (B, N) bool, |sum of the raw row| > 1e-9."""
    return torch.abs(torch.sum(x, dim=-1)) > 1e-9


def kv_pool_forward_plain(x: torch.Tensor, out: torch.Tensor, p: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Masked window pools of the features out (B, N, C) over p
    consecutive rows: pooled (max over valid rows, 0 for an all-invalid
    window), idx (int32 argmax, the lowest tied offset; 0 for an
    all-invalid window) and sums (sum over valid rows)."""
    b, n, c = out.shape
    valid = _valid_rows(x)
    filled = torch.where(valid[..., None], out,
                         torch.full_like(out, float("-inf")))
    fr = filled.reshape(b, n // p, p, c)
    pm = torch.amax(fr, dim=2)
    idx = torch.argmax(fr, dim=2).to(torch.int32)
    pooled = torch.where(torch.isfinite(pm), pm, torch.zeros_like(pm))
    zr = torch.where(valid[..., None], out, torch.zeros_like(out))
    sums = torch.sum(zr.reshape(b, n // p, p, c), dim=2)
    return pooled, idx, sums


def kv_pool_backward_plain(x: torch.Tensor, dpool: torch.Tensor,
                           idx: torch.Tensor, dsums: torch.Tensor,
                           p: int) -> torch.Tensor:
    """Scatter the pooled and window-sum cotangents back onto rows: dpool
    to the argmax row of every window with a valid row, dsums to every
    valid row.  Returns (B, N, C) f32."""
    b, nw, c = dpool.shape
    valid = _valid_rows(x).reshape(b, nw, p)
    win_valid = torch.any(valid, dim=2)
    dp = torch.where(win_valid[..., None], dpool, torch.zeros_like(dpool))
    k_iota = torch.arange(p, dtype=torch.int32, device=dpool.device)
    scat = torch.where(k_iota[None, None, :, None] == idx[:, :, None, :],
                       dp[:, :, None, :], torch.zeros((), device=dp.device))
    scat = scat + torch.where(valid[..., None], dsums[:, :, None, :],
                              torch.zeros((), device=dp.device))
    return scat.reshape(b, nw * p, c)


def chain_forward_plain(x: torch.Tensor, stage_params: Sequence[Tuple],
                        final_w: torch.Tensor, final_b: torch.Tensor, *,
                        kv_pool: int = 0, emit_features: bool = True,
                        compute_dtype=torch.bfloat16, stash: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """K2's contract (K5's forward with stash=False) in plain PyTorch.
    x (B, N, D) f32.  Returns zs (the pre-LN activations of every stage in
    compute_dtype; only with stash), features (B, N, C) f32 when
    emit_features, and pooled, idx, sums (B, N/p, C) when kv_pool."""
    cdt = compute_dtype
    h = x.float().to(cdt)
    zs = []
    for w, b, g, be in stage_params:
        z = dot(h, w, cdt) + b.float()
        zs.append(z.to(cdt))
        h = torch.clamp_min(ln(z, g.float(), be.float()), 0.0).to(cdt)
    out = dot(h, final_w, cdt) + final_b.float()
    result = {"zs": tuple(zs)} if stash else {}
    if emit_features:
        result["features"] = out
    if kv_pool:
        result["pooled"], result["idx"], result["sums"] = \
            kv_pool_forward_plain(x.float(), out, kv_pool)
    return result


def _stage_stats(z, g, be, cdt, eps=1e-6):
    """(h, xhat, rstd) of one stage from its f32 pre-LN activation z."""
    mu = torch.mean(z, dim=-1, keepdim=True)
    var = torch.mean(torch.square(z - mu), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (z - mu) * rstd
    ln = xhat * g.float() + be.float()
    return torch.clamp_min(ln, 0.0).to(cdt), xhat, rstd


def _stages_from_z(x, zs, stage_params, cdt):
    """hs (the compute-dtype input of every product), xhats and rstds,
    rebuilt from the stored pre-LN activations (no products)."""
    hs, xhats, rstds = [x.to(cdt)], [], []
    for z_k, (_w, _b, g, be) in zip(zs, stage_params):
        h, xhat, rstd = _stage_stats(z_k.float(), g, be, cdt)
        hs.append(h)
        xhats.append(xhat)
        rstds.append(rstd)
    return hs, xhats, rstds


def _recompute_stages(x, stage_params, cdt):
    """The same, recomputed (`_recompute_stages`): each stage's z is the
    product in f32 and its statistics come from that f32 z."""
    hs, xhats, rstds = [x.to(cdt)], [], []
    for w, b, g, be in stage_params:
        z = dot(hs[-1], w, cdt) + b.float()
        h, xhat, rstd = _stage_stats(z, g, be, cdt)
        hs.append(h)
        xhats.append(xhat)
        rstds.append(rstd)
    return hs, xhats, rstds


def chain_backward_plain(x: torch.Tensor, stage_params: Sequence[Tuple],
                         final_w: torch.Tensor, final_b: torch.Tensor,
                         zs: Optional[Sequence[torch.Tensor]], *,
                         g: Optional[torch.Tensor] = None, kv_pool: int = 0,
                         dpool: Optional[torch.Tensor] = None,
                         idx: Optional[torch.Tensor] = None,
                         dsums: Optional[torch.Tensor] = None,
                         compute_dtype=torch.bfloat16, need_dx: bool = True,
                         plan: Optional[Dict] = None):
    """K3's contract in plain PyTorch, K5's backward when zs is None.
    Cotangents: g (B, N, C) of the features (None when the flavour has
    none), and with kv_pool dpool, dsums (B, N/p, C) plus the forward's
    idx.  Returns (dx (B, N, D) f32 or None, ((dw, db, dgamma, dbeta), ...)
    f32, dfinal_w, dfinal_b).  With a `remat_plan` (zs None) it runs that
    plan's row chunks as the card does (`_remat_backward_chunked`);
    without one, the whole batch at once."""
    cdt = compute_dtype
    x = x.float()
    b, n, d = x.shape
    m = b * n
    if plan is not None and zs is not None:
        raise ValueError("a remat plan runs the recomputing backward; "
                         "the stash backward takes the whole batch")
    if kv_pool:
        gout = kv_pool_backward_plain(x, dpool, idx, dsums, kv_pool)
        if g is not None:
            gout = gout + g
    else:
        gout = g
    gout = gout.reshape(m, -1).float()
    dfb = torch.sum(gout, dim=0)
    g_cdt = gout.to(cdt)
    if plan is not None:
        return _remat_backward_chunked(x.reshape(m, d), stage_params,
                                       final_w, g_cdt, dfb, plan, cdt,
                                       need_dx, (b, n, d))
    if zs is None:
        hs, xhats, rstds = _recompute_stages(x.reshape(m, d), stage_params,
                                             cdt)
    else:
        hs, xhats, rstds = _stages_from_z(x.reshape(m, d),
                                          [z.reshape(m, -1) for z in zs],
                                          stage_params, cdt)
    dfw = dot(hs[-1].t(), g_cdt, cdt)
    dh = dot(g_cdt, final_w.t(), cdt)
    dstages: List[Tuple] = [None] * len(stage_params)
    for k in reversed(range(len(stage_params))):
        w, _b, gm, be = stage_params[k]
        dz, dlnx, dln = _stage_grads(dh, xhats[k], rstds[k], gm, be)
        dgamma = torch.sum(dlnx, dim=0)
        dbeta = torch.sum(dln, dim=0)
        db = torch.sum(dz, dim=0)
        dz_cdt = dz.to(cdt)
        dw = dot(hs[k].t(), dz_cdt, cdt)
        dstages[k] = (dw, db, dgamma, dbeta)
        if k > 0 or need_dx:
            dh = dot(dz_cdt, w.t(), cdt)
    dx = dh.reshape(b, n, d) if need_dx else None
    return dx, tuple(dstages), dfw, dfb


def _stage_grads(dh, xhat, rstd, gm, be):
    """One stage's ReLU + LayerNorm backward from the cotangent dh of its
    output: (dz, dln * xhat, dln), with jnp.maximum's exact-tie rule
    (g/2 at 0)."""
    gamma = gm.float()
    ln = xhat * gamma + be.float()
    dln = torch.where(ln > 0, dh, torch.where(ln < 0, torch.zeros_like(dh),
                                              0.5 * dh))
    dxhat = dln * gamma
    m1 = torch.mean(dxhat, dim=-1, keepdim=True)
    m2 = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd, dln * xhat, dln


def _remat_backward_chunked(x, stage_params, final_w, g_cdt, dfb, plan, cdt,
                            need_dx, shape):
    """K5's backward as the card runs it by `remat_plan`'s row chunks:
    per chunk the recompute of its rows, the stage backward from its rows
    of the seed g_cdt (m, C) and its rows of dx; each stage's d gamma |
    d beta | d b summed per 128-row tile, the tiles added on in order
    across chunks; every dW = h^T dz summed per K-slice of the chunk's
    plan, the slices added on in order across chunks.  x (m, D) f32."""
    n_stages = len(stage_params)
    widths = [w.shape[1] for w, *_ in stage_params]
    dws = [0.0] * (n_stages + 1)
    sums = [torch.zeros(3 * w, device=x.device) for w in widths]
    dx = torch.empty_like(x) if need_dx else None

    def add_slices(acc, h, dz, slices):
        for s0, s1 in slices:
            acc = acc + dot(h[s0:s1].t(), dz[s0:s1], cdt)
        return acc

    for (r0, r1), slices in zip(plan["chunks"], plan["dw_slices"]):
        hs, xhats, rstds = _recompute_stages(x[r0:r1], stage_params, cdt)
        dz_above = g_cdt[r0:r1]
        dws[-1] = add_slices(dws[-1], hs[-1], dz_above, slices[-1])
        dh = dot(dz_above, final_w.t(), cdt)
        for k in reversed(range(n_stages)):
            w, _b, gm, be = stage_params[k]
            dz, dlnx, dln = _stage_grads(dh, xhats[k], rstds[k], gm, be)
            cols = torch.cat([dlnx, dln, dz], dim=1)
            for t0 in range(0, r1 - r0, BM):
                sums[k] = sums[k] + torch.sum(cols[t0:t0 + BM], dim=0)
            dz_cdt = dz.to(cdt)
            dws[k] = add_slices(dws[k], hs[k], dz_cdt, slices[k])
            if k > 0 or need_dx:
                dh = dot(dz_cdt, w.t(), cdt)
        if need_dx:
            dx[r0:r1] = dh
    dstages = tuple((dws[k], sums[k][2 * w:], sums[k][:w], sums[k][w:2 * w])
                    for k, w in enumerate(widths))
    return (dx.reshape(shape) if need_dx else None, dstages, dws[-1], dfb)


# ---------------------------------------------------------------------------
# K5's backward by row chunks (pure: shapes in, chunks / slices out; the
# GEMM's plan is `hopper_gemm.chain_plan`)
# ---------------------------------------------------------------------------

_SEED_ROWS = 32             # rows of a k3_seed block (its d final_b partials)


# K5's backward recomputes the chain's activations chunk by chunk of rows,
# so that what it holds stops growing with the batch, as the Pallas
# kernel's remat holds one tile's activations in VMEM.  A chunk's
# recomputed f32 z and compute-dtype h of every stage, with the stage
# backward's dz (and a split stage's f32 dh), its LayerNorm / bias
# partials and the widest dW K-slice partials, stay under
# REMAT_CHUNK_BYTES: 1 GiB is ~1.3% of the H100's 80 GB, and it keeps
# every shape up to (8, 2560) of the shipped encoder in one chunk in both
# dtypes (35,072 rows in bf16, 25,344 in f32, against 20,480), so those
# run the launches of one whole-batch pass.  A chunk takes at least
# REMAT_MIN_ROWS rows, 132 row tiles of 128: every stage GEMM of a chunk
# still has a row tile for each of the 132 SMs.
REMAT_CHUNK_BYTES = 1 << 30
REMAT_MIN_ROWS = SMS * BM
_LARGE = 1 << 20            # PyTorch's caching allocator: large blocks


def _alloc(nbytes: int) -> int:
    """The most PyTorch's caching allocator counts for a request of
    `nbytes`: rounded up to 512 bytes and, for a large block, up to 1 MiB
    more (a cached block it does not split)."""
    if nbytes <= 0:
        return 0
    r = -(-nbytes // 512) * 512
    return r + _LARGE if r > _LARGE else r


def _remat_chunk_peak(rows: int, dims: Sequence[int], modes, esize: int,
                      slices) -> int:
    """The most one chunk of `rows` rows holds at once in K5's backward
    (`_backward_cuda`), over each stage k from the last: the f32 z and h
    of stages 0..k, the dz above (not for the last stage: the seed is
    whole-batch), the stage's dz, a split stage's f32 dh, the LayerNorm /
    bias partials of this stage and the one above, and the K-slice
    partials of the dW product above the stage; after the stages, dz0
    with the partials of dW0 = x^T dz0."""
    widths = dims[1:-1]
    tiles = -(-rows // BM)
    dw = [_alloc(len(sl) * i * o * 4) for sl, i, o in
          zip(slices, dims[:-1], dims[1:])]
    held = [_alloc(rows * pad8(w) * 4) + _alloc(rows * pad8(w) * esize)
            for w in widths]
    peak = _alloc(rows * pad8(widths[0]) * esize) + _alloc(
        tiles * 3 * widths[0] * 4) + dw[0]
    for k, w in enumerate(widths):
        above = k + 1 < len(widths)
        peak = max(peak, sum(held[:k + 1])
                   + (_alloc(rows * pad8(widths[k + 1]) * esize) if above
                      else 0)
                   + _alloc(rows * pad8(w) * esize)
                   + (_alloc(rows * pad8(w) * 4) if modes[k] == "split"
                      else 0)
                   + _alloc(tiles * 3 * w * 4)
                   + (_alloc(tiles * 3 * widths[k + 1] * 4) if above else 0)
                   + dw[k + 1])
    return peak


def remat_plan(m: int, d: int, widths: Sequence[int], out: int,
               compute_dtype=torch.bfloat16, *,
               chunk_bytes: Optional[int] = None,
               min_rows: Optional[int] = None) -> Dict:
    """K5's backward by row chunks, from its shapes alone: "chunk_rows",
    the rows of every chunk but the last (the most, a multiple of 128,
    whose peak `_remat_chunk_peak` stays under `chunk_bytes`, and at
    least `min_rows`, and all m when that covers them); "chunks", the
    [start, stop) row ranges that cover 0..m once, in order; "dw_slices",
    per chunk the K-slices (`split_k` over the chunk's rows) of every dW
    product, as `chain_plan`'s over m when there is one chunk;
    "chunk_peak", the bytes the largest chunk holds at once; and
    "peak_bytes", the most one K5 backward call allocates beyond its
    inputs: that chunk peak beside what lives through the call (the
    parameters in the kernels' dtypes, x in the compute dtype and its
    rows' validity, the seed and its d final_b partials, dx, every
    gradient), each buffer as the caching allocator may count it
    (`_alloc`).  "whole_batch_bytes" is what recomputing the whole batch
    at once held: m x the widths x (4 + the compute dtype's size).
    chunk_bytes / min_rows None take REMAT_CHUNK_BYTES / REMAT_MIN_ROWS as
    they stand at the call, so a caller can set them for a whole run."""
    if chunk_bytes is None:
        chunk_bytes = REMAT_CHUNK_BYTES
    if min_rows is None:
        min_rows = REMAT_MIN_ROWS
    plan = chain_plan(m, d, widths, out, compute_dtype)
    esize = 4 if plan["dtypes"]["h"] == torch.float32 else 2
    bk = plan["tile"][2]
    dims = [d, *widths, out]

    def slices(rows):
        return [split_k(rows, i, o, bk=bk) for i, o in
                zip(dims[:-1], dims[1:])]

    def peak(rows):
        return _remat_chunk_peak(rows, dims, plan["modes"], esize,
                                 slices(rows))

    per_row = max(1, (peak(2 * BM) - peak(BM)) // BM)
    rows = min(max(BM, chunk_bytes // per_row // BM * BM), -(-m // BM) * BM)
    while rows > BM and peak(rows) > chunk_bytes:
        rows -= BM
    while rows < m and peak(rows + BM) <= chunk_bytes:
        rows += BM
    rows = min(m, max(rows, -(-min_rows // BM) * BM))
    chunks = [(s, min(m, s + rows)) for s in range(0, m, rows)]
    sizes = sorted({b - a for a, b in chunks})
    chunk_peak = max(peak(r) for r in sizes)
    pairs = list(zip(dims[:-1], dims[1:]))
    lives = [*(i * pad8(o) * esize for i, o in pairs),    # the weights
             *(3 * w * 4 for w in widths), out * 4,         # b, gamma, beta
             m * pad8(d) * esize, m,                        # x, validity
             m * pad8(out) * esize,                         # the seed
             -(-m // _SEED_ROWS) * out * 4, out * 4,        # d final_b
             m * d * 4,                                     # dx
             *(i * o * 4 for i, o in pairs),                # every dW
             *(3 * w * 4 for w in widths)]                  # db, dgamma, dbeta
    return {"chunk_rows": rows,
            "chunks": chunks,
            "dw_slices": [slices(b - a) for a, b in chunks],
            "chunk_peak": chunk_peak,
            "peak_bytes": sum(map(_alloc, lives)) + chunk_peak,
            "whole_batch_bytes": m * sum(widths) * (4 + esize)}


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_FWD, _DH, _DW = 0, 1, 2    # operand forms of k23_gemm


# The chain library's entry points: name -> argument types, each with an
# `_f32` twin of the same arguments for the f32 compute dtype.
_DTYPED = {"k23_prep_x": "PiPiPiP", "k23_gemm": "iPiPiPPiiiiiiP",
           "k2_gemm_ln": "PiPiPPPPiPiiiiiP",
           "k3_gemm_ln_bwd": "PiPiPiiPPPiPiPiiiP",
           "k3_seed": "PPPPPPiPiiiP"}
_SIGNATURES = {"k23_tile": "i", "k23_tile_f32": "i", "k23_smem_bytes": "",
               "k23_max_fused_width": "", "k23_row_chunk": "",
               "k2_window_pool": "PPPPPiiiP", "k3_colsum": "PPiqP",
               "k3_colsum_acc": "PPiqP",
               **_DTYPED, **{k + "_f32": v for k, v in _DTYPED.items()}}


def _check_library(lib) -> None:
    tiles = {"bf16": tuple(lib.k23_tile(k) for k in range(3)),
             "f32": tuple(lib.k23_tile_f32(k) for k in range(3))}
    want = {"bf16": (BM, BN, BK), "f32": (BM, BN, BK_F32)}
    if (tiles != want
            or lib.k23_max_fused_width() != MAX_CLUSTER * BN
            or lib.k23_smem_bytes() != smem_bytes()
            or lib.k23_row_chunk() != _SEED_ROWS):
        raise RuntimeError(
            f"csrc/hopper_gemm.cuh's tiles {tiles}, widest fused stage "
            f"{lib.k23_max_fused_width()}, {lib.k23_smem_bytes()} "
            f"bytes of shared memory and k3_seed's "
            f"{lib.k23_row_chunk()} rows a block do not match the "
            f"plan's {want}, {MAX_CLUSTER * BN} (wider stages run "
            f"split), {smem_bytes()} and {_SEED_ROWS}")


def _lib():
    return library("chain_grad", _SIGNATURES, _check_library)


def _prep_x(lib, x, plan, need_valid, stream, what):
    """x (B, N, D) f32 -> (M, D) in the compute dtype with padded rows, and
    the validity of every row when kv pooling needs it."""
    b, n, d = x.shape
    m = b * n
    cdt = plan["dtypes"]["x"]
    xb = row_buffer(m, d, cdt, x.device)
    valid = torch.empty(m, dtype=torch.uint8,
                        device=x.device) if need_valid else None
    check(entry(lib, "k23_prep_x", cdt)(ptr(x), d, ptr(xb), plan["x_ld"],
                                        ptr(valid), m, stream), what)
    return xb, valid


def _stage_forward(lib, a, k_in, layer, m, stream, *, z_dtype, what):
    """One stage's GEMM + LayerNorm: (h, z) with h in the operand dtype of
    a, and z the stash (bf16, or f32 in f32), the f32 z or None (z_dtype
    None).  K2, K5's forward and K5's recompute all come through here, so
    their h and z agree bit for bit.  A stage in cluster mode is one fused
    launch; a split stage's GEMM writes the f32 z (which is the z itself
    when z_dtype is f32) and `layernorm_relu_forward` does the rest."""
    w, bb, g, be = layer
    width = w.shape[1]
    dev = a.device
    if stage_mode(width) == "split":
        z32 = row_buffer(m, width, torch.float32, dev)
        check(entry(lib, "k23_gemm", a.dtype)(
            _FWD, ptr(a), a.stride(0), ptr(w), w.stride(0), ptr(bb),
            ptr(z32), z32.stride(0), m, width, k_in, 1, k_in, stream),
            what + " (split: GEMM)")
        stash = z_dtype if z_dtype not in (None, torch.float32) else None
        h, z = layernorm_relu_forward(z32, g, be, h_dtype=a.dtype,
                                      stash_dtype=stash)
        return h, z32 if z_dtype == torch.float32 else z
    h = row_buffer(m, width, a.dtype, dev)
    z = None if z_dtype is None else row_buffer(m, width, z_dtype, dev)
    check(entry(lib, "k2_gemm_ln", a.dtype)(
        ptr(a), a.stride(0), ptr(w), w.stride(0), ptr(bb), ptr(g),
        ptr(be), ptr(h), h.stride(0), ptr(z),
        0 if z is None else z.stride(0), int(z_dtype == torch.float32), m,
        width, k_in, stream), what)
    return h, z


def _stage_backward(lib, dz_above, w_above, above_w, z, layer, m, plan,
                    rebuild_h, stream, what):
    """One stage's backward from the cotangent of the product above it
    (dh = dz_above W_above^T) and the stage's z: (dz, the rebuilt h or
    None, per-row-tile column partials of d gamma | d beta | d b).  In
    cluster mode dh stays in the fused epilogue's registers; a split
    stage's GEMM writes the f32 dh and `layernorm_relu_backward` does the
    rest.  The m rows may be one chunk of K5's: the partials are that
    chunk's row tiles."""
    _w, _bb, gm, be = layer
    width = _w.shape[1]
    dev = dz_above.device
    cdt = plan["dtypes"]["dz"]
    if stage_mode(width) == "split":
        dh = row_buffer(m, width, torch.float32, dev)
        check(entry(lib, "k23_gemm", cdt)(
            _DH, ptr(dz_above), dz_above.stride(0), ptr(w_above),
            w_above.stride(0), None, ptr(dh), dh.stride(0), m, width,
            above_w, 1, above_w, stream), what + " (split: dh GEMM)")
        return layernorm_relu_backward(z, dh, gm, be, dz_dtype=cdt,
                                       rebuild_h=rebuild_h)
    dz = row_buffer(m, width, cdt, dev)
    hout = (row_buffer(m, width, plan["dtypes"]["h"], dev) if rebuild_h
            else None)
    part = torch.empty((-(-m // BM), 3 * width), dtype=torch.float32,
                       device=dev)
    check(entry(lib, "k3_gemm_ln_bwd", cdt)(
        ptr(dz_above), dz_above.stride(0), ptr(w_above),
        w_above.stride(0), ptr(z), z.stride(0),
        int(z.dtype == torch.float32), ptr(gm), ptr(be), ptr(dz),
        dz.stride(0), ptr(hout), 0 if hout is None else hout.stride(0),
        ptr(part), m, width, above_w, stream), what)
    return dz, hout, part


def _gemm_tn(lib, a, b, slices, rows, i, h, stream, what, acc=None
             ) -> torch.Tensor:
    """(i, h) f32 = a^T b with a stored (rows, i), b (rows, h), both with
    padded rows and in one compute dtype: the K=rows sum is split into
    `slices` whose partials are summed in slice order.  With `acc` (an
    earlier chunk's sum) the partials are added on to it, in order, and
    acc is returned."""
    ksplit = slices[0][1] - slices[0][0]
    splits = len(slices)
    out = torch.empty((i, h), dtype=torch.float32,
                      device=b.device) if acc is None else acc
    dst = out if splits == 1 and acc is None else torch.empty(
        (splits, i, h), dtype=torch.float32, device=b.device)
    check(entry(lib, "k23_gemm", b.dtype)(
        _DW, ptr(a), a.stride(0), ptr(b), b.stride(0), None, ptr(dst), h,
        i, h, rows, splits, ksplit, stream), what)
    if dst is not out:
        _colsum(lib, dst, out, splits, i * h, acc is not None, stream,
                what + " slice sum")
    return out


def _colsum(lib, part, out, nparts, ncols, acc, stream, what) -> None:
    """out = the nparts rows of part summed in order, or with acc added
    on to out in order (`k3_colsum_acc`)."""
    check((lib.k3_colsum_acc if acc else lib.k3_colsum)(
        ptr(part), ptr(out), nparts, ncols, stream), what)


def _check_pool(n, kv_pool):
    if kv_pool and n % kv_pool:
        raise ValueError(f"N={n} is not a multiple of kv_pool={kv_pool}")


def _forward_cuda(x, stage_params, final_w, final_b, *, kv_pool,
                  emit_features, compute_dtype, stash=True):
    """K2 (stash) or K5's forward (no stash)."""
    cdt = kernel_dtype(compute_dtype)
    layers, fw, fb = gemm_operands(x, stage_params, final_w, final_b, cdt,
                                   "the chain kernels")
    b, n, d = x.shape
    _check_pool(n, kv_pool)
    m = b * n
    c = fw.shape[1]
    plan = chain_plan(m, d, [w.shape[1] for w, *_ in layers], c, cdt)
    dev = x.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    a, valid = _prep_x(lib, x, plan, bool(kv_pool), stream, "chain input")
    k_in = d
    zs = []
    for layer in layers:
        a, z = _stage_forward(lib, a, k_in, layer, m, stream,
                              z_dtype=plan["dtypes"]["stash"] if stash
                              else None,
                              what="chain stage GEMM + LayerNorm")
        if stash:
            zs.append(z.unflatten(0, (b, n)))
        k_in = layer[0].shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    check(entry(lib, "k23_gemm", cdt)(
        _FWD, ptr(a), a.stride(0), ptr(fw), fw.stride(0), ptr(fb),
        ptr(out), c, m, c, k_in, 1, k_in, stream), "chain projection GEMM")
    result = {"zs": tuple(zs)} if stash else {}
    if emit_features:
        result["features"] = out
    if kv_pool:
        nw = n // kv_pool
        pooled = torch.empty((b, nw, c), dtype=torch.float32, device=dev)
        idx = torch.empty((b, nw, c), dtype=torch.int32, device=dev)
        sums = torch.empty((b, nw, c), dtype=torch.float32, device=dev)
        check(lib.k2_window_pool(ptr(out), ptr(valid), ptr(pooled),
                                 ptr(idx), ptr(sums), b * nw, c, kv_pool,
                                 stream), "chain window pool")
        result.update(pooled=pooled, idx=idx, sums=sums)
    count("K2" if stash else "K5 fwd", cdt)
    return result


def _backward_cuda(x, stage_params, final_w, final_b, zs, *, g, kv_pool,
                   dpool, idx, dsums, compute_dtype, need_dx, **chunking):
    """K3 from the stash zs, in one pass over the batch; or K5's backward
    when zs is None, chunk by chunk of `remat_plan` (`chunking`: its
    chunk_bytes and min_rows): per chunk the recompute, the stage
    backward from the chunk's rows of the seed, the chunk's rows of dx,
    its row tiles' LayerNorm / bias partials added on to the sums in tile
    order and its dW K-slices added on to each dW in slice order."""
    cdt = kernel_dtype(compute_dtype)
    layers, fw, _fb = gemm_operands(x, stage_params, final_w, final_b, cdt,
                                    "the chain kernels")
    b, n, d = x.shape
    _check_pool(n, kv_pool)
    dev = x.device
    m = b * n
    c = fw.shape[1]
    widths = [w.shape[1] for w, *_ in layers]
    remat = zs is None
    kern = "K5" if remat else "K3"
    plan = chain_plan(m, d, widths, c, cdt)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not remat:
        for z, width in zip(zs, widths):
            if z.shape != (b, n, width) or z.device != dev:
                raise ValueError(f"stash {tuple(z.shape)} does not match "
                                 f"({b}, {n}, {width})")
        zs = [tma_rows(z.reshape(m, width), plan["dtypes"]["stash"])
              for z, width in zip(zs, widths)]
    cotangents = [("g", g, (b, n, c))]
    if kv_pool:
        cotangents += [(k, t, (b, n // kv_pool, c)) for k, t in
                       (("dpool", dpool), ("idx", idx), ("dsums", dsums))]
    for what, t, shape in cotangents:
        if t is not None and (t.shape != shape or t.device != dev):
            raise ValueError(f"{what} {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {dev}")
    if g is not None:
        g = g.float().contiguous()
    if kv_pool:
        dpool = dpool.float().contiguous()
        dsums = dsums.float().contiguous()
        idx = idx.to(torch.int32).contiguous()
    elif g is None:
        raise ValueError("the chain without kv_pool needs the features' "
                         "cotangent")
    xb, valid = _prep_x(lib, x, plan, bool(kv_pool), stream,
                        f"{kern} input")

    # Seed: the projection's cotangent, in the compute dtype, and
    # d final_b.
    nblk = -(-m // lib.k23_row_chunk())
    gbf = row_buffer(m, c, plan["dtypes"]["seed"], dev)
    part = torch.empty((nblk, c), dtype=torch.float32, device=dev)
    check(entry(lib, "k3_seed", cdt)(
        ptr(dpool) if kv_pool else None, ptr(idx) if kv_pool else None,
        ptr(dsums) if kv_pool else None, ptr(valid), ptr(g), ptr(gbf),
        gbf.stride(0), ptr(part), m, c, kv_pool, stream), f"{kern} seed")
    dfb = torch.empty(c, dtype=torch.float32, device=dev)
    check(lib.k3_colsum(ptr(part), ptr(dfb), nblk, c, stream),
          f"{kern} d final_b")

    if remat:
        rplan = remat_plan(m, d, widths, c, cdt, **chunking)
        chunks, slices = rplan["chunks"], rplan["dw_slices"]
    else:
        chunks, slices = [(0, m)], [plan["dw_slices"]]
    n_stages = len(layers)
    dx = torch.empty((b, n, d), dtype=torch.float32,
                     device=dev) if need_dx else None
    sums = [torch.empty(3 * w, dtype=torch.float32, device=dev)
            for w in widths]
    dws: List[Optional[torch.Tensor]] = [None] * (n_stages + 1)
    for ci, (r0, r1) in enumerate(chunks):
        rows, acc = r1 - r0, ci > 0
        xc = xb[r0:r1]
        if remat:
            # This chunk's f32 z and h of every stage, recomputed by the
            # forward's own kernel, so both are bit-identical to the
            # forward's; freed stage by stage below.
            zc, hc = [], []
            a, k_in = xc, d
            for layer in layers:
                a, z = _stage_forward(lib, a, k_in, layer, rows, stream,
                                      z_dtype=plan["dtypes"]["recomputed_z"],
                                      what="K5 recompute GEMM + LayerNorm")
                zc.append(z)
                hc.append(a)
                k_in = layer[0].shape[1]
            del a, z
        else:
            zc = list(zs)
        dz_above, w_above, above_w = gbf[r0:r1], fw, c
        for k in reversed(range(n_stages)):
            width = widths[k]
            dz, hout, part = _stage_backward(
                lib, dz_above, w_above, above_w, zc[k], layers[k], rows,
                plan, not remat, stream, f"{kern} dh GEMM + stage backward")
            _colsum(lib, part, sums[k], part.shape[0], 3 * width, acc,
                    stream, f"{kern} LayerNorm / bias gradients")
            # The product above this stage: its input h is this stage's
            # output (K3 rebuilds it from the stash, K5 recomputed it).
            hin = hc[k] if remat else hout
            dws[k + 1] = _gemm_tn(lib, hin, dz_above, slices[ci][k + 1],
                                  rows, width, above_w, stream,
                                  f"{kern} dW = h^T dz", dws[k + 1])
            zc[k] = hin = hout = None
            if remat:
                hc[k] = None
            dz_above, w_above, above_w = dz, layers[k][0], width
            del dz
        del part
        if need_dx:
            check(entry(lib, "k23_gemm", cdt)(
                _DH, ptr(dz_above), dz_above.stride(0), ptr(w_above),
                w_above.stride(0), None, ptr(dx) + r0 * d * 4, d, rows, d,
                above_w, 1, above_w, stream), f"{kern} dx = dz W^T")
        dws[0] = _gemm_tn(lib, xc, dz_above, slices[ci][0], rows, d,
                          widths[0], stream, f"{kern} dW0 = x^T dz", dws[0])
        del dz_above, xc
    dstages = tuple((dws[k], sums[k][2 * w:], sums[k][:w],
                     sums[k][w:2 * w]) for k, w in enumerate(widths))
    count("K5 bwd" if remat else "K3", cdt)
    return dx, dstages, dws[n_stages], dfb


def chain_forward(x, stage_params, final_w, final_b, *, kv_pool=0,
                  emit_features=True, compute_dtype=torch.bfloat16):
    """K2: the CUDA kernels for a CUDA cloud, the plain version for a CPU
    cloud.  Same arguments and result as `chain_forward_plain`."""
    kw = dict(kv_pool=kv_pool, emit_features=emit_features,
              compute_dtype=compute_dtype)
    if not on_card(x, "K2"):
        return chain_forward_plain(x, stage_params, final_w, final_b, **kw)
    return _forward_cuda(x, stage_params, final_w, final_b, **kw)


def chain_backward(x, stage_params, final_w, final_b, zs, *, g=None,
                   kv_pool=0, dpool=None, idx=None, dsums=None,
                   compute_dtype=torch.bfloat16, need_dx=True):
    """K3: the CUDA kernels for a CUDA cloud, the plain version for a CPU
    cloud.  Same arguments and result as `chain_backward_plain`."""
    if zs is None:
        raise ValueError("K3 needs the stash; remat_chain_backward "
                         "recomputes it")
    kw = dict(g=g, kv_pool=kv_pool, dpool=dpool, idx=idx, dsums=dsums,
              compute_dtype=compute_dtype, need_dx=need_dx)
    if not on_card(x, "K3"):
        return chain_backward_plain(x, stage_params, final_w, final_b, zs,
                                    **kw)
    return _backward_cuda(x, stage_params, final_w, final_b, zs, **kw)


def remat_chain_forward(x, stage_params, final_w, final_b, *, kv_pool=0,
                        emit_features=True, compute_dtype=torch.bfloat16):
    """K5's forward: K2 without the stash.  Same arguments as
    `chain_forward`; the result has no "zs"."""
    kw = dict(kv_pool=kv_pool, emit_features=emit_features,
              compute_dtype=compute_dtype, stash=False)
    if not on_card(x, "K5"):
        return chain_forward_plain(x, stage_params, final_w, final_b, **kw)
    return _forward_cuda(x, stage_params, final_w, final_b, **kw)


def remat_chain_backward(x, stage_params, final_w, final_b, *, g=None,
                         kv_pool=0, dpool=None, idx=None, dsums=None,
                         compute_dtype=torch.bfloat16, need_dx=True,
                         chunk_bytes=None, min_rows=None):
    """K5's backward: recomputes the stage activations and runs K3's stage
    backward, chunk by chunk of rows (`remat_plan` with chunk_bytes and
    min_rows), so that it holds about chunk_bytes beside the seed and the
    gradients whatever the batch.  Same arguments and result as
    `chain_backward` without zs.  On the CPU: the plain version over the
    whole batch, or over the plan's chunks when either is given."""
    kw = dict(g=g, kv_pool=kv_pool, dpool=dpool, idx=idx, dsums=dsums,
              compute_dtype=compute_dtype, need_dx=need_dx)
    chunking = dict(chunk_bytes=chunk_bytes, min_rows=min_rows)
    if not on_card(x, "K5"):
        plan = None
        if chunk_bytes is not None or min_rows is not None:
            b, n, d = x.shape
            plan = remat_plan(b * n, d, [w.shape[1] for w, *_ in
                                         stage_params], final_w.shape[1],
                              compute_dtype, **chunking)
        return chain_backward_plain(x, stage_params, final_w, final_b, None,
                                    plan=plan, **kw)
    return _backward_cuda(x, stage_params, final_w, final_b, None, **kw,
                          **chunking)


def _unflatten(flat, n_stages):
    stages = tuple(tuple(flat[4 * i: 4 * i + 4]) for i in range(n_stages))
    return stages, flat[4 * n_stages], flat[4 * n_stages + 1]


class _Chain(torch.autograd.Function):
    """stash: forward = K2 (saves x, the parameters, the stash and the
    argmax), backward = K3.  remat: forward and backward = K5 (saves x,
    the parameters and the argmax, never a z_k; the backward holds one
    chunk of rows' recomputed z and h at a time, `remat_plan`).  dx only
    when x needs a gradient."""

    @staticmethod
    def forward(ctx, x, n_stages, kv_pool, emit_features, compute_dtype,
                remat, *flat):
        stages, fw, fb = _unflatten(flat, n_stages)
        fwd = remat_chain_forward if remat else chain_forward
        res = fwd(x, stages, fw, fb, kv_pool=kv_pool,
                  emit_features=emit_features, compute_dtype=compute_dtype)
        kept = [res["idx"]] if kv_pool else []
        ctx.save_for_backward(x, *flat, *res.get("zs", ()), *kept)
        ctx.meta = (n_stages, kv_pool, emit_features, compute_dtype, remat)
        ctx.set_materialize_grads(False)
        outs = ([res["features"]] if emit_features else []) + (
            [res["pooled"], res["sums"]] if kv_pool else [])
        return tuple(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        n_stages, kv_pool, emit_features, compute_dtype, remat = ctx.meta
        saved = ctx.saved_tensors
        x = saved[0]
        flat = saved[1: 1 + 4 * n_stages + 2]
        zs = None if remat else saved[1 + 4 * n_stages + 2:
                                      1 + 5 * n_stages + 2]
        idx = saved[-1] if kv_pool else None
        none = (None,) * (6 + len(flat))
        g = grads[0] if emit_features else None
        dpool = dsums = None
        if kv_pool:
            dpool, dsums = grads[-2], grads[-1]
            if dpool is None and dsums is None and g is None:
                return none
            if dpool is None:
                dpool = torch.zeros_like(idx, dtype=torch.float32)
            if dsums is None:
                dsums = torch.zeros_like(idx, dtype=torch.float32)
        elif g is None:
            return none
        stages, fw, fb = _unflatten(flat, n_stages)
        kw = dict(g=g, kv_pool=kv_pool, dpool=dpool, idx=idx, dsums=dsums,
                  compute_dtype=compute_dtype,
                  need_dx=ctx.needs_input_grad[0])
        if remat:
            grads = remat_chain_backward(x, stages, fw, fb, **kw)
        else:
            grads = chain_backward(x, stages, fw, fb, zs, **kw)
        dx, dstages, dfw, dfb = grads
        dflat = [t for st in dstages for t in st] + [dfw, dfb]
        dflat = [dt.to(p.dtype).reshape(p.shape)
                 for dt, p in zip(dflat, flat)]
        return (dx, None, None, None, None, None, *dflat)


def differentiable_chain(x: torch.Tensor, stage_params: Sequence[Tuple],
                         final_w: torch.Tensor, final_b: torch.Tensor, *,
                         kv_pool: int = 0, emit_features: bool = True,
                         compute_dtype=torch.bfloat16,
                         backward: str = "remat"):
    """The training chain x (B, N, D) -> features, (features, pooled, sums)
    or (pooled, sums), differentiable in x and every parameter.  backward:
    "remat" (K5) or "stash" (K2 + K3), as `make_differentiable_chain`."""
    if backward not in ("remat", "stash"):
        raise ValueError(f"unknown chain backward {backward!r}")
    if not emit_features and kv_pool <= 1:
        raise ValueError("emit_features=False requires kv_pool > 1")
    flat = [t for st in stage_params for t in st] + [final_w, final_b]
    return _Chain.apply(x, len(stage_params), kv_pool, emit_features,
                        compute_dtype, backward == "remat", *flat)
