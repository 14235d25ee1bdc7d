"""K1, the fused point encoder: per-point MLP stack + pooling reductions.

Port of `wireframe_tpu/ops/pallas_encoder.py`.  This is the FLOPs-dominant
path of the whole model: a 5-stage shared MLP (input_dim -> 512 -> 1024
-> 2048 -> 1024 -> 512 with LayerNorm+ReLU between stages) applied to
every point, followed by four pooling reductions over the point axis
(masked mean/max for the encoder's global feature, unmasked mean/max for
the legacy vertex head) and, with `kv_pool`, the decoder's masked window
max-pool.

Three functions over one parameter layout:
- `point_encoder_reference`: the plain chain (point features only);
- `fused_point_encoder_plain`: the plain PyTorch version of K1's whole
  contract, used for CPU tensors and as the kernel's oracle on the card;
- `fused_point_encoder`: launches the hand-written CUDA kernel
  (`csrc/fused_encoder.cu` on the wgmma + TMA GEMM of
  `csrc/hopper_gemm.cuh`) for CUDA tensors, in bf16 or f32 (the JAX
  kernel's two compute dtypes; f32 on the GEMM's 3xTF32 main loop), and
  takes the plain version only for CPU tensors (`ops._launch`); each
  call counts "K1" or "K1 f32".  `k1_plan` is its launch plan, pure, so
  the CPU tests reach everything around the kernel.

`ln` and `dot` are the plain math K2 / K3 / K5's plain versions share.

bf16 matmuls with f32 accumulation are written as f32 matmuls of
bf16-rounded operands: every bf16 x bf16 product is exact in f32, so this
is the kernel's arithmetic up to summation order.  A reference on the
card keeps TF32 off (PyTorch's default), so these run in full f32.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch

from wireframe_tpu_torch.ops._launch import (
    check,
    count,
    entry,
    library,
    on_card,
    pad8,
    ptr,
    row_buffer,
)
from wireframe_tpu_torch.ops.hopper_gemm import (
    BM,
    F32_FLUSH_K,
    chain_plan,
    gemm_operands,
    kernel_dtype,
)
from wireframe_tpu_torch.ops.layernorm_rows import layernorm_relu_forward

_NEG_INF = -1e30


def ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-6) -> torch.Tensor:
    """Two-pass LayerNorm, as pallas_encoder.py:_ln."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def dot(h: torch.Tensor, w: torch.Tensor,
         compute_dtype: torch.dtype) -> torch.Tensor:
    """`compute_dtype` operands, f32 accumulation."""
    return torch.matmul(h.to(compute_dtype).float(),
                        w.to(compute_dtype).float())


def point_encoder_reference(x: torch.Tensor,
                            stage_params: Sequence[Tuple],
                            final_w: torch.Tensor, final_b: torch.Tensor,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain chain.  x: (..., D); stage_params: [(w (I, H), b, ln_scale,
    ln_bias), ...].  Returns point features (..., output_dim) in f32."""
    h = x.to(compute_dtype)
    for w, b, g, be in stage_params:
        h = dot(h, w, compute_dtype) + b.float()
        h = ln(h, g.float(), be.float())
        # torch.maximum, not relu: its gradient at an exact 0 is half the
        # cotangent, as jnp.maximum's (the plain chain is the training
        # path when the kernels are off).
        h = torch.maximum(h, torch.zeros_like(h))
        h = h.to(compute_dtype)
    return dot(h, final_w, compute_dtype) + final_b.float()


def _check_tiling(n: int, tile: int, kv_pool: int) -> None:
    # The JAX kernel's own asserts (pallas_encoder.py:100-104); the
    # encoder module only routes shapes that pass them.
    if n % tile:
        raise ValueError(f"N={n} not divisible by tile={tile}")
    if kv_pool and not (tile % kv_pool == 0 and (
            (tile // kv_pool) % 8 == 0 or tile // kv_pool == n // kv_pool)):
        raise ValueError(f"kv_pool={kv_pool} does not fit tile={tile}")


def fused_point_encoder_plain(x: torch.Tensor,
                              stage_params: Sequence[Tuple],
                              final_w: torch.Tensor, final_b: torch.Tensor,
                              *, tile: int = 256,
                              return_point_features: bool = False,
                              compute_dtype=torch.bfloat16,
                              kv_pool: int = 0) -> Dict[str, torch.Tensor]:
    """K1's contract in plain PyTorch.

    x: (B, N, D) float32; all-zero rows are padding (excluded from the
    masked pools, INCLUDED in the unmasked pools).  Returns masked_mean,
    masked_max, mean, max (each (B, C) f32), plus point_features (B, N, C)
    if requested and kv_features (B, N/kv_pool, C) if kv_pool.
    """
    b, n, _ = x.shape
    _check_tiling(n, tile, kv_pool)
    x = x.float()
    feats = point_encoder_reference(x, stage_params, final_w, final_b,
                                    compute_dtype)
    mask = torch.abs(torch.sum(x, dim=-1)) > 1e-9              # (B, N)
    filled = torch.where(mask[..., None], feats,
                         torch.full_like(feats, _NEG_INF))
    count = torch.clamp_min(torch.sum(mask.float(), dim=-1), 1.0)
    masked_max = torch.amax(filled, dim=1)
    result = {
        "masked_mean": torch.sum(feats * mask[..., None].float(), dim=1)
        / count[:, None],
        "masked_max": torch.where(masked_max > _NEG_INF / 2, masked_max,
                                  torch.zeros_like(masked_max)),
        "mean": torch.sum(feats, dim=1) / n,
        "max": torch.amax(feats, dim=1),
    }
    if return_point_features:
        result["point_features"] = feats
    if kv_pool:
        pm = torch.amax(filled.reshape(b, n // kv_pool, kv_pool, -1), dim=2)
        result["kv_features"] = torch.where(pm > _NEG_INF / 2, pm,
                                            torch.zeros_like(pm))
    return result


# ---------------------------------------------------------------------------
# The launch plan (pure: shapes in, tiles / windows / strides out)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def k1_plan(b: int, n: int, d: int, widths: Tuple[int, ...], out: int,
            kv_pool: int, compute_dtype=torch.bfloat16) -> Dict:
    """What one K1 call on the card launches, from its shapes alone.

    The projection runs its 128-row tiles per cloud, so no tile holds rows
    of two clouds: "tile_rows" are the [start, stop) cloud rows of each
    tile (the same for every cloud), "partials" the shape of the per-tile
    pools.  With kv_pool = p, "windows" gives per tile (the range of
    windows that lie in it whole, the window of its edge slot 0 or None,
    that of slot 1 or None): slot 0 holds the part of a window that began
    in an earlier tile, slot 1 the part of one that begins here and ends in
    a later tile.  "merges" lists, as the finalize kernel walks them, every
    window that crosses a tile boundary with the (tile, slot) partials it
    takes the max of; "edges" says whether the edge slots exist at all.
    Row strides are padded for TMA.  Each stage's "modes" entry says how
    it runs its LayerNorm (`hopper_gemm.stage_mode`): ("cluster", ctas) in
    its GEMM's epilogue across a cluster of ceil(W / 256) <= 8 CTAs, or
    "split" for a stage wider than 2048 (its f32 z in device memory, then
    the LayerNorm row kernel); "clusters" the CTAs (None when split).  For
    the compute dtype: the main loop, tile, stage and shared-memory bytes
    and buffer dtypes, as `chain_plan` gives them, and "peak_bytes", the
    device memory one call allocates at its fullest: two consecutive
    activations (the input and stage 0's h first, then each stage's h
    beside the next's; a split stage's f32 z beside both) or the last h
    with the projection's outputs (kv tokens, partials, edge slots, pools;
    in f32 after a stage wider than F32_FLUSH_K also the f32 features, in
    which the projection parks its partial sums), whichever is more,
    beside the rows' validity."""
    bm = BM                     # rows of a projection tile
    tiles = -(-n // bm)
    spans = [(t * bm, min(n, (t + 1) * bm)) for t in range(tiles)]
    windows, merges = None, []
    p = kv_pool
    if p:
        if n % p:
            raise ValueError(f"N={n} is not a multiple of kv_pool={p}")
        windows = []
        for r0, r1 in spans:
            last = (r1 - 1) // p
            windows.append((range(-(-r0 // p), r1 // p),
                            r0 // p if r0 % p else None,
                            last if r0 <= last * p and (last + 1) * p > r1
                            else None))
        for k in range(1, tiles):       # k1_finalize_kernel's walk
            w = k * bm // p
            if k * bm % p == 0 or w * p < (k - 1) * bm:
                continue
            parts = [(k - 1, 1)] + [(j, 0) for j in range(k, tiles)
                                    if j * bm < (w + 1) * p]
            merges.append((w, parts))
    cplan = chain_plan(b * n, d, widths, out, compute_dtype)
    esize = 4 if cplan["dtypes"]["h"] == torch.float32 else 2
    acts = [b * n * pad8(w) * esize for w in (d, *widths)]
    split_z = [b * n * pad8(w) * 4 if mode == "split" else 0
               for w, mode in zip(widths, cplan["modes"])]
    outs = 4 * (b * (n // p) * out if p else 0) + 4 * b * tiles * 5 * out \
        + (4 * b * tiles * 2 * out if merges else 0) + 4 * b * 4 * out \
        + (4 * b * n * out if esize == 4 and widths[-1] > F32_FLUSH_K else 0)
    peak = b * n + max([x + y + z for x, y, z in zip(acts, acts[1:], split_z)]
                       + [acts[-1] + outs])
    return {"tiles_per_cloud": tiles,
            "row_tiles": b * tiles,
            "tile_rows": spans,
            "partials": (b, tiles, 5, out),
            "windows": windows,
            "merges": merges,
            "edges": bool(merges),
            "x_ld": pad8(d),
            "stage_ld": [pad8(w) for w in widths],
            "modes": cplan["modes"],
            "clusters": cplan["clusters"],
            **{k: cplan[k] for k in ("main_loop", "tile", "stages",
                                     "stage_bytes", "split_bytes",
                                     "smem_bytes", "split", "dtypes")},
            "peak_bytes": peak}


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_DTYPED = {"k1_prep": "PiPiPiP", "k1_stage": "PiPiPPPPiiiiP",
           "k1_gemm_z": "PiPiPPiiiiP", "k1_project": "PiPiPPPiPPPiiiiiP"}
_SIGNATURES = {"k1_row_tile": "", "k1_finalize": "PPPPiiiiP", **_DTYPED,
               **{k + "_f32": v for k, v in _DTYPED.items()}}


def _check_library(lib) -> None:
    if lib.k1_row_tile() != BM:
        raise RuntimeError(f"csrc/hopper_gemm.cuh's row tile "
                           f"{lib.k1_row_tile()} does not match the "
                           f"plan's {BM}")


def _lib():
    return library("fused_encoder", _SIGNATURES, _check_library)


def _launch(x, stage_params, final_w, final_b, *, tile,
            return_point_features, compute_dtype, kv_pool):
    cdt = kernel_dtype(compute_dtype)
    layers, fw, fb = gemm_operands(x, stage_params, final_w, final_b, cdt,
                                   "K1")
    b, n, d = x.shape
    _check_tiling(n, tile, kv_pool)
    dev = x.device
    c = fw.shape[1]
    plan = k1_plan(b, n, d, tuple(w.shape[1] for w, *_ in layers), c,
                   kv_pool, cdt)

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = b * n
    a = row_buffer(m, d, cdt, dev)
    valid = torch.empty(m, dtype=torch.uint8, device=dev)
    check(entry(lib, "k1_prep", cdt)(ptr(x), d, ptr(a), plan["x_ld"],
                                     ptr(valid), m, stream), "K1 input prep")
    k_in = d
    for (w, bb, g, be), mode in zip(layers, plan["modes"]):
        # Each stage's h is the only activation in device memory (with a
        # split stage's f32 z while it runs); the one before it is freed as
        # soon as this stage's launches are queued.
        width = w.shape[1]
        if mode == "split":
            z = row_buffer(m, width, torch.float32, dev)
            check(entry(lib, "k1_gemm_z", cdt)(
                ptr(a), a.stride(0), ptr(w), w.stride(0), ptr(bb),
                ptr(z), z.stride(0), m, width, k_in, stream),
                "K1 stage GEMM (split)")
            h, _ = layernorm_relu_forward(z, g, be, h_dtype=cdt)
            del z
        else:
            h = row_buffer(m, width, cdt, dev)
            check(entry(lib, "k1_stage", cdt)(
                ptr(a), a.stride(0), ptr(w), w.stride(0), ptr(bb),
                ptr(g), ptr(be), ptr(h), h.stride(0), m, width, k_in,
                stream), "K1 stage GEMM + LayerNorm")
        a, k_in = h, width
    p = kv_pool
    # In f32 past F32_FLUSH_K the projection parks its partial sums in the
    # features, so it gets them whether asked for or not.
    feats = (torch.empty((b, n, c), dtype=torch.float32, device=dev)
             if return_point_features or (
                 cdt == torch.float32 and k_in > F32_FLUSH_K) else None)
    kv = torch.empty((b, n // p, c), dtype=torch.float32, device=dev) \
        if p else None
    part = torch.empty(plan["partials"], dtype=torch.float32, device=dev)
    edge = torch.empty((b, plan["tiles_per_cloud"], 2, c),
                       dtype=torch.float32, device=dev) \
        if plan["edges"] else None
    pools = torch.empty((b, 4, c), dtype=torch.float32, device=dev)
    check(entry(lib, "k1_project", cdt)(
        ptr(a), a.stride(0), ptr(fw), fw.stride(0), ptr(fb), ptr(valid),
        ptr(feats), c, ptr(part), ptr(kv), ptr(edge), p, b, n, c, k_in,
        stream), "K1 projection GEMM + pools")
    check(lib.k1_finalize(ptr(part), ptr(edge), ptr(kv), ptr(pools), b,
                          n, p, c, stream), "K1 pool finalize")
    count("K1", cdt)
    result = {"masked_mean": pools[:, 0], "masked_max": pools[:, 1],
              "mean": pools[:, 2], "max": pools[:, 3]}
    if return_point_features:
        result["point_features"] = feats
    if kv_pool:
        result["kv_features"] = kv
    return result


def fused_point_encoder(x: torch.Tensor,
                        stage_params: Sequence[Tuple],
                        final_w: torch.Tensor, final_b: torch.Tensor,
                        *, tile: int = 256,
                        return_point_features: bool = False,
                        compute_dtype=torch.bfloat16,
                        kv_pool: int = 0) -> Dict[str, torch.Tensor]:
    """K1: the CUDA kernel for a CUDA cloud, the plain version for a CPU
    cloud.  Same arguments and result as `fused_point_encoder_plain`; on
    the card it raises on anything the kernel does not take (a compute
    dtype other than bf16 or f32, misaligned or non-contiguous input,
    ragged tiling)."""
    kwargs = dict(tile=tile, return_point_features=return_point_features,
                  compute_dtype=compute_dtype, kv_pool=kv_pool)
    if not on_card(x, "K1"):
        return fused_point_encoder_plain(x, stage_params, final_w, final_b,
                                         **kwargs)
    return _launch(x, stage_params, final_w, final_b, **kwargs)
