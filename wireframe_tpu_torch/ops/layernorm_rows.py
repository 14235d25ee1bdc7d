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
  tile order as it sums the fused epilogue's.

Each takes its plain version (`*_plain`, the arithmetic of
`chain_grad.chain_forward_plain` / `chain_backward_plain` for one stage)
for CPU tensors and launches the kernels for CUDA tensors, counting
`.launches` (bf16) or `.launches_f32` (f32).  `chain_grad.chain_plan`
and `fused_encoder.k1_plan` name the stages that run split.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

ROW_TILE = 128          # rows of a backward partial (the GEMM's row tile)
LN_EPS = 1e-6


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
# The CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    from wireframe_tpu_torch.ops import _build

    lib = _build.load("layernorm_rows")
    if not getattr(lib, "_ln_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for sfx in ("", "_f32"):
            fn = getattr(lib, "ln_rows_fwd" + sfx)
            fn.argtypes = [p, i, p, p, p, i, p, i, i, i, p]
            fn.restype = i
            fn = getattr(lib, "ln_rows_bwd" + sfx)
            fn.argtypes = [p, i, i, p, i, p, p, p, p, i, p, i, p, i, i, p]
            fn.restype = i
        lib.ln_rows_tile.argtypes, lib.ln_rows_tile.restype = [], i
        if lib.ln_rows_tile() != ROW_TILE:
            raise RuntimeError(f"csrc/layernorm_rows.cu's row tile "
                               f"{lib.ln_rows_tile()} is not {ROW_TILE}")
        lib._ln_typed = True
    return lib


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
    return [t.to(torch.float32).contiguous() for t in (gamma, beta)]


def layernorm_relu_forward(z: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, *, h_dtype,
                           stash_dtype=None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The split stage's forward: the CUDA kernel for a CUDA z, the plain
    version for a CPU z.  z (M, W) f32 with unit column stride; h_dtype
    bf16 or f32; stash_dtype None or, with bf16 h, bf16.  On the card h
    and the stash have rows a multiple of 8 elements apart."""
    if z.device.type == "cpu":
        return layernorm_relu_forward_plain(z, gamma, beta, h_dtype=h_dtype,
                                            stash_dtype=stash_dtype)
    if z.device.type != "cuda":
        raise ValueError(f"the LayerNorm rows run on CUDA or CPU tensors, "
                         f"not {z.device}")
    from wireframe_tpu_torch.ops.chain_grad import (
        KERNEL_DTYPES,
        _check,
        _count,
        _rows,
    )

    m, w = z.shape
    _check_rows("z", z, m, w, (torch.float32,))
    if h_dtype not in KERNEL_DTYPES or stash_dtype not in (
            None, torch.bfloat16) or (stash_dtype is not None
                                      and h_dtype != torch.bfloat16):
        raise ValueError(f"h in bf16 or f32 and a bf16 stash only beside "
                         f"bf16 h; got {h_dtype}, {stash_dtype}")
    dev = z.device
    g, b = _params(gamma, beta, w, dev)
    h = _rows(m, w, h_dtype, dev)
    stash = None if stash_dtype is None else _rows(m, w, stash_dtype, dev)
    f32 = h_dtype == torch.float32
    lib = _lib()
    _check(getattr(lib, "ln_rows_fwd" + ("_f32" if f32 else ""))(
        z.data_ptr(), z.stride(0), g.data_ptr(), b.data_ptr(), h.data_ptr(),
        h.stride(0), None if stash is None else stash.data_ptr(),
        0 if stash is None else stash.stride(0), m, w,
        torch.cuda.current_stream(dev).cuda_stream), "LayerNorm rows forward")
    _count(layernorm_relu_forward, h_dtype)
    return h, stash


def layernorm_relu_backward(z: torch.Tensor, dh: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor, *,
                            dz_dtype, rebuild_h: bool):
    """The split stage's backward: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  z (M, W): the bf16 stash (with bf16
    dz) or the f32 z; dh (M, W) f32.  Returns (dz, h or None, part); on
    the card dz and h have rows a multiple of 8 elements apart."""
    if z.device.type == "cpu":
        return layernorm_relu_backward_plain(z, dh, gamma, beta,
                                             dz_dtype=dz_dtype,
                                             rebuild_h=rebuild_h)
    if z.device.type != "cuda":
        raise ValueError(f"the LayerNorm rows run on CUDA or CPU tensors, "
                         f"not {z.device}")
    from wireframe_tpu_torch.ops.chain_grad import (
        KERNEL_DTYPES,
        _check,
        _count,
        _rows,
    )

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
    dz = _rows(m, w, dz_dtype, dev)
    h = _rows(m, w, dz_dtype, dev) if rebuild_h else None
    stats = torch.empty((m, 4), dtype=torch.float32, device=dev)
    part = torch.empty((-(-m // ROW_TILE), 3 * w), dtype=torch.float32,
                       device=dev)
    f32 = dz_dtype == torch.float32
    lib = _lib()
    _check(getattr(lib, "ln_rows_bwd" + ("_f32" if f32 else ""))(
        z.data_ptr(), z.stride(0), int(z.dtype == torch.float32),
        dh.data_ptr(), dh.stride(0), g.data_ptr(), b.data_ptr(),
        stats.data_ptr(), dz.data_ptr(), dz.stride(0),
        None if h is None else h.data_ptr(), 0 if h is None else h.stride(0),
        part.data_ptr(), m, w, torch.cuda.current_stream(dev).cuda_stream),
        "LayerNorm rows backward")
    _count(layernorm_relu_backward, dz_dtype)
    return dz, h, part


for _wrapper in (layernorm_relu_forward, layernorm_relu_backward):
    _wrapper.launches = 0
    _wrapper.launches_f32 = 0
