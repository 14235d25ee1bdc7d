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
  (`csrc/fused_encoder.cu`) for CUDA tensors, and takes the plain version
  only for CPU tensors.  `fused_point_encoder.launches` counts kernel
  launches.

bf16 matmuls with f32 accumulation are written as f32 matmuls of
bf16-rounded operands: every bf16 x bf16 product is exact in f32, so this
is the kernel's arithmetic up to summation order.  A reference on the
card keeps TF32 off (PyTorch's default), so these run in full f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

_NEG_INF = -1e30
_POOL_CHUNK = 128   # rows per pooling partial on the card


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


def _lib() -> ctypes.CDLL:
    from wireframe_tpu_torch.ops import _build

    lib = _build.load("fused_encoder")
    if not getattr(lib, "_k1_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_gemm_bias.argtypes = [p, i, p, p, p, i, i, i, p]
        lib.k1_ln_relu.argtypes = [p, p, p, p, i, i, p]
        lib.k1_pool.argtypes = [p, i, p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.k1_gemm_bias, lib.k1_ln_relu, lib.k1_pool):
            fn.restype = ctypes.c_int
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
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("K1 takes a contiguous (B, N, D) float32 cloud, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("the K1 kernel computes in bfloat16 only "
                         f"(compute_dtype={compute_dtype})")
    if x.data_ptr() % 16:
        raise ValueError("K1 needs a 16-byte aligned cloud")
    b, n, d = x.shape
    _check_tiling(n, tile, kv_pool)
    dev = x.device
    layers = []
    prev = d
    for w, bb, g, be in stage_params:
        if w.dim() != 2 or w.shape[0] != prev or w.shape[1] % 4:
            raise ValueError(f"stage weight {tuple(w.shape)} does not follow "
                             f"width {prev} (widths must be multiples of 4)")
        layers.append(tuple(_aligned(t, dt) for t, dt in (
            (w, torch.bfloat16), (bb, torch.float32), (g, torch.float32),
            (be, torch.float32))))
        prev = w.shape[1]
    if final_w.dim() != 2 or final_w.shape[0] != prev:
        raise ValueError(f"final weight {tuple(final_w.shape)} does not "
                         f"follow width {prev}")
    fw = _aligned(final_w, torch.bfloat16)
    fb = _aligned(final_b, torch.float32)
    c = fw.shape[1]
    for t in (*[t for layer in layers for t in layer], fw, fb):
        if t.device != dev:
            raise ValueError("K1 parameters must lie on the cloud's device")

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = b * n
    widest = max([w.shape[1] for w, *_ in layers], default=0)
    z = torch.empty(m * widest, dtype=torch.float32, device=dev)
    h = torch.empty(m * widest, dtype=torch.bfloat16, device=dev)
    a, a_is_f32, k = x, 1, d
    for w, bb, g, be in layers:
        width = w.shape[1]
        _check(lib.k1_gemm_bias(a.data_ptr(), a_is_f32, w.data_ptr(),
                                bb.data_ptr(), z.data_ptr(), m, width, k,
                                stream), "stage GEMM")
        _check(lib.k1_ln_relu(z.data_ptr(), g.data_ptr(), be.data_ptr(),
                              h.data_ptr(), m, width, stream), "LayerNorm")
        a, a_is_f32, k = h, 0, width
    feats = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    _check(lib.k1_gemm_bias(a.data_ptr(), a_is_f32, fw.data_ptr(),
                            fb.data_ptr(), feats.data_ptr(), m, c, k, stream),
           "projection GEMM")

    p = kv_pool
    chunk = _POOL_CHUNK if not p else p * -(-_POOL_CHUNK // p)
    nchunks = -(-n // chunk)
    kv = (torch.empty((b, n // p, c), dtype=torch.float32, device=dev)
          if p else None)
    part = torch.empty((b, nchunks, 5, c), dtype=torch.float32, device=dev)
    pools = torch.empty((b, 4, c), dtype=torch.float32, device=dev)
    _check(lib.k1_pool(x.data_ptr(), d, feats.data_ptr(),
                       kv.data_ptr() if p else None, part.data_ptr(),
                       pools.data_ptr(), b, n, c, p, chunk, stream), "pooling")
    fused_point_encoder.launches += 1
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
    the card it raises on anything the kernel does not take (non-bf16
    compute, misaligned or non-contiguous input, ragged tiling)."""
    kwargs = dict(tile=tile, return_point_features=return_point_features,
                  compute_dtype=compute_dtype, kv_pool=kv_pool)
    if x.device.type == "cpu":
        return fused_point_encoder_plain(x, stage_params, final_w, final_b,
                                         **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, stage_params, final_w, final_b, **kwargs)


fused_point_encoder.launches = 0
