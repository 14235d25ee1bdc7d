"""K2 + K3, the differentiable point chain of the training step (stash).

Port of the stash flavours of `wireframe_tpu/ops/pallas_chain_grad.py`:
the per-point MLP (Linear + LayerNorm + ReLU per stage, plain Linear
projection) as a `torch.autograd.Function` whose

- forward is **K2** (`_chain_forward_stash_pallas`): the chain, with each
  stage's pre-LayerNorm activation z_k stored in the compute dtype and,
  with kv_pool = p > 1, the masked window max / int32 argmax / masked
  window sum of the features over p consecutive rows (`_kv_pool_tile_fwd`);
- backward is **K3** (`_chain_backward_pallas` with zs): the kv cotangent
  scatter (`_kv_pool_tile_bwd`), the LayerNorm statistics rebuilt from the
  stored z (`_stages_from_z`), then per stage the ReLU backward with
  `jnp.maximum`'s tie rule (half the cotangent where ln == 0 exactly), the
  LayerNorm backward, dW = h^T dz and dh = dz W^T, in f32.

Three flavours, as `make_differentiable_chain(backward="stash")`:
  kv_pool = 0                      -> features (B, N, C)
  kv_pool > 1, emit_features       -> (features, pooled, sums)
  kv_pool > 1, not emit_features   -> (pooled, sums)   [the recipe]
`backward="remat"` is K5 and raises NotImplementedError (ROADMAP.md A2).

Each kernel has its plain PyTorch version here (`chain_forward_plain`,
`chain_backward_plain`, the arithmetic written out, not autograd); the
wrappers `chain_forward` / `chain_backward` take it for CPU tensors and
launch the CUDA kernels (`csrc/chain_grad.cu`) for CUDA tensors, counting
kernel launches in `.launches`.  Products of `compute_dtype` operands with
f32 accumulation are written as f32 products of rounded operands (exact
products, f32 sums), as in `ops.fused_encoder`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from wireframe_tpu_torch.ops.fused_encoder import _aligned, _dot, _ln

_REMAT = ("chain_backward='remat' (the non-stash forward and the "
          "recomputing backward, K5) is not ported yet: ROADMAP.md item A2")


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
                        compute_dtype=torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
    """K2's contract in plain PyTorch.  x (B, N, D) f32.  Returns zs (the
    pre-LN activations of every stage in compute_dtype), features (B, N, C)
    f32 when emit_features, and pooled, idx, sums (B, N/p, C) when kv_pool.
    """
    cdt = compute_dtype
    h = x.float().to(cdt)
    zs = []
    for w, b, g, be in stage_params:
        z = _dot(h, w, cdt) + b.float()
        zs.append(z.to(cdt))
        h = torch.clamp_min(_ln(z, g.float(), be.float()), 0.0).to(cdt)
    out = _dot(h, final_w, cdt) + final_b.float()
    result = {"zs": tuple(zs)}
    if emit_features:
        result["features"] = out
    if kv_pool:
        result["pooled"], result["idx"], result["sums"] = \
            kv_pool_forward_plain(x.float(), out, kv_pool)
    return result


def _stages_from_z(x, zs, stage_params, cdt, eps=1e-6):
    """hs (the compute-dtype input of every product), xhats and rstds,
    rebuilt from the stored pre-LN activations (no products)."""
    hs, xhats, rstds = [x.to(cdt)], [], []
    for z_k, (_w, _b, g, be) in zip(zs, stage_params):
        z = z_k.float()
        mu = torch.mean(z, dim=-1, keepdim=True)
        var = torch.mean(torch.square(z - mu), dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xhat = (z - mu) * rstd
        ln = xhat * g.float() + be.float()
        hs.append(torch.clamp_min(ln, 0.0).to(cdt))
        xhats.append(xhat)
        rstds.append(rstd)
    return hs, xhats, rstds


def chain_backward_plain(x: torch.Tensor, stage_params: Sequence[Tuple],
                         final_w: torch.Tensor, final_b: torch.Tensor,
                         zs: Sequence[torch.Tensor], *,
                         g: Optional[torch.Tensor] = None, kv_pool: int = 0,
                         dpool: Optional[torch.Tensor] = None,
                         idx: Optional[torch.Tensor] = None,
                         dsums: Optional[torch.Tensor] = None,
                         compute_dtype=torch.bfloat16, need_dx: bool = True):
    """K3's contract in plain PyTorch.  Cotangents: g (B, N, C) of the
    features (None when the flavour has none), and with kv_pool dpool,
    dsums (B, N/p, C) plus the forward's idx.  Returns (dx (B, N, D) f32 or
    None, ((dw, db, dgamma, dbeta), ...) f32, dfinal_w, dfinal_b)."""
    cdt = compute_dtype
    x = x.float()
    b, n, d = x.shape
    m = b * n
    hs, xhats, rstds = _stages_from_z(x.reshape(m, d),
                                      [z.reshape(m, -1) for z in zs],
                                      stage_params, cdt)
    if kv_pool:
        gout = kv_pool_backward_plain(x, dpool, idx, dsums, kv_pool)
        if g is not None:
            gout = gout + g
    else:
        gout = g
    gout = gout.reshape(m, -1).float()
    dfb = torch.sum(gout, dim=0)
    g_cdt = gout.to(cdt)
    dfw = _dot(hs[-1].t(), g_cdt, cdt)
    dh = _dot(g_cdt, final_w.t(), cdt)
    dstages: List[Tuple] = [None] * len(stage_params)
    for k in reversed(range(len(stage_params))):
        w, _b, gm, be = stage_params[k]
        xhat, rstd = xhats[k], rstds[k]
        gamma = gm.float()
        ln = xhat * gamma + be.float()
        # ReLU backward with jnp.maximum's exact-tie rule (g/2 at 0).
        dln = torch.where(ln > 0, dh, torch.where(ln < 0,
                                                  torch.zeros_like(dh),
                                                  0.5 * dh))
        dgamma = torch.sum(dln * xhat, dim=0)
        dbeta = torch.sum(dln, dim=0)
        dxhat = dln * gamma
        m1 = torch.mean(dxhat, dim=-1, keepdim=True)
        m2 = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
        dz = (dxhat - m1 - xhat * m2) * rstd
        db = torch.sum(dz, dim=0)
        dz_cdt = dz.to(cdt)
        dw = _dot(hs[k].t(), dz_cdt, cdt)
        dstages[k] = (dw, db, dgamma, dbeta)
        if k > 0 or need_dx:
            dh = _dot(dz_cdt, w.t(), cdt)
    dx = dh.reshape(b, n, d) if need_dx else None
    return dx, tuple(dstages), dfw, dfb


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    from wireframe_tpu_torch.ops import _build

    lib = _build.load("chain_grad")
    if not getattr(lib, "_k23_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k23_gemm.argtypes = [p, i, i, p, i, p, p, i, i, i, i, i, p]
        lib.k23_row_valid.argtypes = [p, i, p, i, p]
        lib.k2_ln_relu_stash.argtypes = [p, p, p, p, p, i, i, p]
        lib.k2_window_pool.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.k3_seed.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.k3_row_bwd.argtypes = [p, p, p, p, p, p, p, i, i, p]
        lib.k3_colsum.argtypes = [p, p, i, ctypes.c_longlong, p]
        lib.k23_row_chunk.argtypes = lib.k23_max_width.argtypes = []
        for fn in (lib.k23_gemm, lib.k23_row_valid, lib.k2_ln_relu_stash,
                   lib.k2_window_pool, lib.k3_seed, lib.k3_row_bwd,
                   lib.k3_colsum, lib.k23_row_chunk, lib.k23_max_width):
            fn.restype = ctypes.c_int
        lib._k23_typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


_SPLIT_ROWS = 512     # least rows per K-slice of a split h^T dz product
_SMS = 132            # H100 SXM streaming multiprocessors


def _gemm(lib, a, a_f32, a_col, b, b_col, bias, c, m, n, k, stream,
          what):
    _check(lib.k23_gemm(_ptr(a), a_f32, a_col, _ptr(b), b_col, _ptr(bias),
                        _ptr(c), m, n, k, 1, k, stream), what)


def _gemm_tn(lib, a, a_f32, b, rows, i, h, stream, what) -> torch.Tensor:
    """(i, h) f32 = a^T b with a stored (rows, i), b (rows, h): the K=rows
    sum is split into slices whose partials are summed in slice order."""
    tiles = -(-i // 128) * -(-h // 128)
    splits = max(1, min(-(-2 * _SMS // tiles), rows // _SPLIT_ROWS))
    per_slice = -(-rows // splits)
    ksplit = -(-per_slice // 32) * 32          # slices start on a K tile
    splits = -(-rows // ksplit)
    out = torch.empty((i, h), dtype=torch.float32, device=b.device)
    if splits == 1:
        _check(lib.k23_gemm(_ptr(a), a_f32, 1, _ptr(b), 0, None, _ptr(out),
                            i, h, rows, 1, rows, stream), what)
        return out
    part = torch.empty((splits, i, h), dtype=torch.float32, device=b.device)
    _check(lib.k23_gemm(_ptr(a), a_f32, 1, _ptr(b), 0, None, _ptr(part),
                        i, h, rows, splits, ksplit, stream), what)
    _check(lib.k3_colsum(_ptr(part), _ptr(out), splits, i * h, stream),
           what + " slice sum")
    return out


def _cuda_params(stage_params, final_w, final_b, x):
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("the chain kernels take a contiguous (B, N, D) "
                         f"float32 cloud, got {x.dtype} {tuple(x.shape)}")
    prev = x.shape[-1]
    layers = []
    for w, b, g, be in stage_params:
        if w.dim() != 2 or w.shape[0] != prev:
            raise ValueError(f"stage weight {tuple(w.shape)} does not follow "
                             f"width {prev}")
        layers.append((_aligned(w, torch.bfloat16), _aligned(b, torch.float32),
                       _aligned(g, torch.float32), _aligned(be, torch.float32)))
        prev = w.shape[1]
    if final_w.dim() != 2 or final_w.shape[0] != prev:
        raise ValueError(f"final weight {tuple(final_w.shape)} does not "
                         f"follow width {prev}")
    fw = _aligned(final_w, torch.bfloat16)
    fb = _aligned(final_b, torch.float32)
    for t in (*[t for layer in layers for t in layer], fw, fb):
        if t.device != x.device:
            raise ValueError("chain parameters must lie on the cloud's device")
    return layers, fw, fb


def _check_pool(n, kv_pool):
    if kv_pool and n % kv_pool:
        raise ValueError(f"N={n} is not a multiple of kv_pool={kv_pool}")


def _forward_cuda(x, stage_params, final_w, final_b, *, kv_pool,
                  emit_features, compute_dtype):
    if compute_dtype != torch.bfloat16:
        raise ValueError("the chain kernels compute in bfloat16 only "
                         f"(compute_dtype={compute_dtype})")
    layers, fw, fb = _cuda_params(stage_params, final_w, final_b, x)
    b, n, d = x.shape
    _check_pool(n, kv_pool)
    dev = x.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = b * n
    widest = max([w.shape[1] for w, *_ in layers], default=8)
    z = torch.empty(m * widest, dtype=torch.float32, device=dev)
    h = torch.empty(m * widest, dtype=torch.bfloat16, device=dev)
    zs = []
    a, a_f32, k = x, 1, d
    for w, bb, g, be in layers:
        width = w.shape[1]
        zk = torch.empty((b, n, width), dtype=torch.bfloat16, device=dev)
        _gemm(lib, a, a_f32, 0, w, 0, bb, z, m, width, k, stream,
              "K2 stage GEMM")
        _check(lib.k2_ln_relu_stash(_ptr(z), _ptr(g), _ptr(be), _ptr(h),
                                    _ptr(zk), m, width, stream),
               "K2 LayerNorm")
        zs.append(zk)
        a, a_f32, k = h, 0, width
    c = fw.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    _gemm(lib, a, a_f32, 0, fw, 0, fb, out, m, c, k, stream,
          "K2 projection GEMM")
    result = {"zs": tuple(zs)}
    if emit_features:
        result["features"] = out
    if kv_pool:
        valid = torch.empty(m, dtype=torch.uint8, device=dev)
        _check(lib.k23_row_valid(_ptr(x), d, _ptr(valid), m, stream),
               "K2 validity")
        nw = n // kv_pool
        pooled = torch.empty((b, nw, c), dtype=torch.float32, device=dev)
        idx = torch.empty((b, nw, c), dtype=torch.int32, device=dev)
        sums = torch.empty((b, nw, c), dtype=torch.float32, device=dev)
        _check(lib.k2_window_pool(_ptr(out), _ptr(valid), _ptr(pooled),
                                  _ptr(idx), _ptr(sums), b * nw, c, kv_pool,
                                  stream), "K2 window pool")
        result.update(pooled=pooled, idx=idx, sums=sums)
    chain_forward.launches += 1
    return result


def _backward_cuda(x, stage_params, final_w, final_b, zs, *, g, kv_pool,
                   dpool, idx, dsums, compute_dtype, need_dx):
    if compute_dtype != torch.bfloat16:
        raise ValueError("the chain kernels compute in bfloat16 only "
                         f"(compute_dtype={compute_dtype})")
    layers, fw, _fb = _cuda_params(stage_params, final_w, final_b, x)
    b, n, d = x.shape
    _check_pool(n, kv_pool)
    dev = x.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = b * n
    c = fw.shape[1]
    widths = [w.shape[1] for w, *_ in layers]
    if max(widths + [c]) > lib.k23_max_width():
        raise ValueError(f"K3 takes widths up to {lib.k23_max_width()}")
    zs = [z.to(torch.bfloat16).contiguous() for z in zs]
    for z, width in zip(zs, widths):
        if z.shape != (b, n, width) or z.device != dev:
            raise ValueError(f"stash {tuple(z.shape)} does not match "
                             f"({b}, {n}, {width})")
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
    chunk = lib.k23_row_chunk()
    nblk = -(-m // chunk)

    # Seed: the projection's cotangent, in bf16, and d final_b.
    valid = None
    if kv_pool:
        valid = torch.empty(m, dtype=torch.uint8, device=dev)
        _check(lib.k23_row_valid(_ptr(x), d, _ptr(valid), m, stream),
               "K3 validity")
        dpool = dpool.float().contiguous()
        dsums = dsums.float().contiguous()
        idx = idx.to(torch.int32).contiguous()
    elif g is None:
        raise ValueError("the chain without kv_pool needs the features' "
                         "cotangent")
    gbf = torch.empty((m, c), dtype=torch.bfloat16, device=dev)
    part = torch.empty((nblk, c), dtype=torch.float32, device=dev)
    _check(lib.k3_seed(_ptr(dpool) if kv_pool else None,
                       _ptr(idx) if kv_pool else None,
                       _ptr(dsums) if kv_pool else None, _ptr(valid),
                       _ptr(g), _ptr(gbf), _ptr(part), m, c, kv_pool, stream),
           "K3 seed")
    dfb = torch.empty(c, dtype=torch.float32, device=dev)
    _check(lib.k3_colsum(_ptr(part), _ptr(dfb), nblk, c, stream),
           "K3 d final_b")

    widest = max(widths)
    dh_bufs = [torch.empty(m * widest, dtype=torch.float32, device=dev)
               for _ in range(2)]
    dz_bufs = [torch.empty(m * widest, dtype=torch.bfloat16, device=dev)
               for _ in range(2)]
    hout = torch.empty(m * widest, dtype=torch.bfloat16, device=dev)
    dh = dh_bufs[0]
    _gemm(lib, gbf, 0, 0, fw, 1, None, dh, m, widths[-1], c, stream,
          "K3 dh = g fw^T")
    n_stages = len(layers)
    dstages: List[Tuple] = [None] * n_stages
    dfw = None
    dz_above = gbf
    dx = None
    for k in reversed(range(n_stages)):
        w, _bb, gm, be = layers[k]
        width = widths[k]
        dz = dz_bufs[k % 2]
        part = torch.empty((nblk, 3 * width), dtype=torch.float32,
                           device=dev)
        _check(lib.k3_row_bwd(_ptr(zs[k]), _ptr(gm), _ptr(be), _ptr(dh),
                              _ptr(dz), _ptr(hout), _ptr(part), m, width,
                              stream), "K3 stage backward")
        sums = torch.empty(3 * width, dtype=torch.float32, device=dev)
        _check(lib.k3_colsum(_ptr(part), _ptr(sums), nblk, 3 * width,
                             stream), "K3 LayerNorm / bias gradients")
        dgamma, dbeta, db = sums[:width], sums[width:2 * width], \
            sums[2 * width:]
        # The product above this stage: hout is its input h.
        above_w = c if k == n_stages - 1 else widths[k + 1]
        dw_above = _gemm_tn(lib, hout, 0, dz_above, m, width, above_w,
                            stream, "K3 dW = h^T dz")
        if k == n_stages - 1:
            dfw = dw_above
        else:
            dstages[k + 1] = (dw_above, *dstages[k + 1][1:])
        dstages[k] = (None, db, dgamma, dbeta)
        if k > 0:
            dh = dh_bufs[(n_stages - k) % 2]
            _gemm(lib, dz, 0, 0, w, 1, None, dh, m, w.shape[0], width,
                  stream, "K3 dh = dz W^T")
        elif need_dx:
            dx = torch.empty((b, n, d), dtype=torch.float32, device=dev)
            _gemm(lib, dz, 0, 0, w, 1, None, dx, m, d, width, stream,
                  "K3 dx = dz W^T")
        dz_above = dz
    dw0 = _gemm_tn(lib, x, 1, dz_above, m, d, widths[0], stream,
                   "K3 dW0 = x^T dz")
    dstages[0] = (dw0, *dstages[0][1:])
    chain_backward.launches += 1
    return dx, tuple(dstages), dfw, dfb


def chain_forward(x, stage_params, final_w, final_b, *, kv_pool=0,
                  emit_features=True, compute_dtype=torch.bfloat16):
    """K2: the CUDA kernels for a CUDA cloud, the plain version for a CPU
    cloud.  Same arguments and result as `chain_forward_plain`."""
    kw = dict(kv_pool=kv_pool, emit_features=emit_features,
              compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        return chain_forward_plain(x, stage_params, final_w, final_b, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {x.device}")
    return _forward_cuda(x, stage_params, final_w, final_b, **kw)


def chain_backward(x, stage_params, final_w, final_b, zs, *, g=None,
                   kv_pool=0, dpool=None, idx=None, dsums=None,
                   compute_dtype=torch.bfloat16, need_dx=True):
    """K3: the CUDA kernels for a CUDA cloud, the plain version for a CPU
    cloud.  Same arguments and result as `chain_backward_plain`."""
    kw = dict(g=g, kv_pool=kv_pool, dpool=dpool, idx=idx, dsums=dsums,
              compute_dtype=compute_dtype, need_dx=need_dx)
    if x.device.type == "cpu":
        return chain_backward_plain(x, stage_params, final_w, final_b, zs,
                                    **kw)
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {x.device}")
    return _backward_cuda(x, stage_params, final_w, final_b, zs, **kw)


chain_forward.launches = 0
chain_backward.launches = 0


def _unflatten(flat, n_stages):
    stages = tuple(tuple(flat[4 * i: 4 * i + 4]) for i in range(n_stages))
    return stages, flat[4 * n_stages], flat[4 * n_stages + 1]


class _StashChain(torch.autograd.Function):
    """forward = K2 (saves x, the parameters, the stash and the argmax),
    backward = K3 (dx only when x needs a gradient)."""

    @staticmethod
    def forward(ctx, x, n_stages, kv_pool, emit_features, compute_dtype,
                *flat):
        stages, fw, fb = _unflatten(flat, n_stages)
        res = chain_forward(x, stages, fw, fb, kv_pool=kv_pool,
                            emit_features=emit_features,
                            compute_dtype=compute_dtype)
        kept = [res["idx"]] if kv_pool else []
        ctx.save_for_backward(x, *flat, *res["zs"], *kept)
        ctx.meta = (n_stages, kv_pool, emit_features, compute_dtype)
        ctx.set_materialize_grads(False)
        outs = ([res["features"]] if emit_features else []) + (
            [res["pooled"], res["sums"]] if kv_pool else [])
        return tuple(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        n_stages, kv_pool, emit_features, compute_dtype = ctx.meta
        saved = ctx.saved_tensors
        x = saved[0]
        flat = saved[1: 1 + 4 * n_stages + 2]
        zs = saved[1 + 4 * n_stages + 2: 1 + 5 * n_stages + 2]
        idx = saved[-1] if kv_pool else None
        g = grads[0] if emit_features else None
        dpool = dsums = None
        if kv_pool:
            dpool, dsums = grads[-2], grads[-1]
            if dpool is None and dsums is None and g is None:
                return (None,) * (5 + len(flat))
            if dpool is None:
                dpool = torch.zeros_like(idx, dtype=torch.float32)
            if dsums is None:
                dsums = torch.zeros_like(idx, dtype=torch.float32)
        elif g is None:
            return (None,) * (5 + len(flat))
        stages, fw, fb = _unflatten(flat, n_stages)
        dx, dstages, dfw, dfb = chain_backward(
            x, stages, fw, fb, zs, g=g, kv_pool=kv_pool, dpool=dpool,
            idx=idx, dsums=dsums, compute_dtype=compute_dtype,
            need_dx=ctx.needs_input_grad[0])
        dflat = [t for st in dstages for t in st] + [dfw, dfb]
        dflat = [dt.to(p.dtype).reshape(p.shape)
                 for dt, p in zip(dflat, flat)]
        return (dx, None, None, None, None, *dflat)


def differentiable_chain(x: torch.Tensor, stage_params: Sequence[Tuple],
                         final_w: torch.Tensor, final_b: torch.Tensor, *,
                         kv_pool: int = 0, emit_features: bool = True,
                         compute_dtype=torch.bfloat16,
                         backward: str = "stash"):
    """The training chain x (B, N, D) -> features, (features, pooled, sums)
    or (pooled, sums), differentiable in x and every parameter."""
    if backward == "remat":
        raise NotImplementedError(_REMAT)
    if backward != "stash":
        raise ValueError(f"unknown chain backward {backward!r}")
    if not emit_features and kv_pool <= 1:
        raise ValueError("emit_features=False requires kv_pool > 1")
    flat = [t for st in stage_params for t in st] + [final_w, final_b]
    return _StashChain.apply(x, len(stage_params), kv_pool, emit_features,
                             compute_dtype, *flat)
