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
  takes the plain version only for CPU tensors.
  `fused_point_encoder.launches` counts bf16 kernel launches,
  `.launches_f32` f32 ones.  `k1_plan` is its launch plan, pure, so the
  CPU tests reach everything around the kernel.

bf16 matmuls with f32 accumulation are written as f32 matmuls of
bf16-rounded operands: every bf16 x bf16 product is exact in f32, so this
is the kernel's arithmetic up to summation order.  A reference on the
card keeps TF32 off (PyTorch's default), so these run in full f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

_NEG_INF = -1e30


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-6) -> torch.Tensor:
    """Two-pass LayerNorm, as pallas_encoder.py:_ln."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _dot(h: torch.Tensor, w: torch.Tensor,
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
        h = _dot(h, w, compute_dtype) + b.float()
        h = _ln(h, g.float(), be.float())
        # torch.maximum, not relu: its gradient at an exact 0 is half the
        # cotangent, as jnp.maximum's (the plain chain is the training
        # path when the kernels are off).
        h = torch.maximum(h, torch.zeros_like(h))
        h = h.to(compute_dtype)
    return _dot(h, final_w, compute_dtype) + final_b.float()


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

K1_ROW_TILE = 128   # rows of a projection tile (csrc/hopper_gemm.cuh's BM)


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
    it runs its LayerNorm (`chain_grad.stage_mode`): ("cluster", ctas) in
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
    from wireframe_tpu_torch.ops.chain_grad import (
        F32_FLUSH_K,
        chain_plan,
        pad8,
    )

    bm = K1_ROW_TILE
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

def _lib() -> ctypes.CDLL:
    from wireframe_tpu_torch.ops import _build

    lib = _build.load("fused_encoder")
    if not getattr(lib, "_k1_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        types = {"k1_row_tile": [],
                 "k1_prep": [p, i, p, i, p, i, p],
                 "k1_stage": [p, i, p, i, p, p, p, p, i, i, i, i, p],
                 "k1_gemm_z": [p, i, p, i, p, p, i, i, i, i, p],
                 "k1_project": [p, i, p, i, p, p, p, i, p, p, p, i, i, i,
                                i, i, p],
                 "k1_finalize": [p, p, p, p, i, i, i, i, p]}
        for name in ("k1_prep", "k1_stage", "k1_gemm_z", "k1_project"):
            types[name + "_f32"] = types[name]
        for name, args in types.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        if lib.k1_row_tile() != K1_ROW_TILE:
            raise RuntimeError(f"csrc/hopper_gemm.cuh's row tile "
                               f"{lib.k1_row_tile()} does not match the "
                               f"plan's {K1_ROW_TILE}")
        lib._k1_typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"K1 {what} launch failed: cudaError_t {err}")


def _aligned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Contiguous `dtype` copy of a parameter whose pointer is 16-byte
    aligned (the kernels load 16-byte vectors)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, stage_params, final_w, final_b, *, tile,
            return_point_features, compute_dtype, kv_pool):
    from wireframe_tpu_torch.ops.chain_grad import (
        F32_FLUSH_K,
        _count,
        _fn,
        _ptr,
        _rows,
        _tma_rows,
        kernel_dtype,
    )
    from wireframe_tpu_torch.ops.layernorm_rows import layernorm_relu_forward

    cdt = kernel_dtype(compute_dtype)
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("K1 takes a contiguous (B, N, D) float32 cloud, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, n, d = x.shape
    _check_tiling(n, tile, kv_pool)
    dev = x.device
    layers = []
    prev = d
    for w, bb, g, be in stage_params:
        if w.dim() != 2 or w.shape[0] != prev:
            raise ValueError(f"stage weight {tuple(w.shape)} does not follow "
                             f"width {prev}")
        layers.append((_tma_rows(w, cdt),
                       *(_aligned(t, torch.float32) for t in (bb, g, be))))
        prev = w.shape[1]
    if final_w.dim() != 2 or final_w.shape[0] != prev:
        raise ValueError(f"final weight {tuple(final_w.shape)} does not "
                         f"follow width {prev}")
    fw = _tma_rows(final_w, cdt)
    fb = _aligned(final_b, torch.float32)
    c = fw.shape[1]
    for t in (*[t for layer in layers for t in layer], fw, fb):
        if t.device != dev:
            raise ValueError("K1 parameters must lie on the cloud's device")
    plan = k1_plan(b, n, d, tuple(w.shape[1] for w, *_ in layers), c,
                   kv_pool, cdt)

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = b * n
    a = _rows(m, d, cdt, dev)
    valid = torch.empty(m, dtype=torch.uint8, device=dev)
    _check(_fn(lib, "k1_prep", cdt)(_ptr(x), d, _ptr(a), plan["x_ld"],
                                    _ptr(valid), m, stream), "input prep")
    k_in = d
    for (w, bb, g, be), mode in zip(layers, plan["modes"]):
        # Each stage's h is the only activation in device memory (with a
        # split stage's f32 z while it runs); the one before it is freed as
        # soon as this stage's launches are queued.
        width = w.shape[1]
        if mode == "split":
            z = _rows(m, width, torch.float32, dev)
            _check(_fn(lib, "k1_gemm_z", cdt)(
                _ptr(a), a.stride(0), _ptr(w), w.stride(0), _ptr(bb),
                _ptr(z), z.stride(0), m, width, k_in, stream),
                "stage GEMM (split)")
            h, _ = layernorm_relu_forward(z, g, be, h_dtype=cdt)
            del z
        else:
            h = _rows(m, width, cdt, dev)
            _check(_fn(lib, "k1_stage", cdt)(
                _ptr(a), a.stride(0), _ptr(w), w.stride(0), _ptr(bb),
                _ptr(g), _ptr(be), _ptr(h), h.stride(0), m, width, k_in,
                stream), "stage GEMM + LayerNorm")
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
    _check(_fn(lib, "k1_project", cdt)(
        _ptr(a), a.stride(0), _ptr(fw), fw.stride(0), _ptr(fb), _ptr(valid),
        _ptr(feats), c, _ptr(part), _ptr(kv), _ptr(edge), p, b, n, c, k_in,
        stream), "projection GEMM + pools")
    _check(lib.k1_finalize(_ptr(part), _ptr(edge), _ptr(kv), _ptr(pools), b,
                           n, p, c, stream), "pool finalize")
    _count(fused_point_encoder, cdt)
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
    if x.device.type == "cpu":
        return fused_point_encoder_plain(x, stage_params, final_w, final_b,
                                         **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, stage_params, final_w, final_b, **kwargs)


fused_point_encoder.launches = 0
fused_point_encoder.launches_f32 = 0
