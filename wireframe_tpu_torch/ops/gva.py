"""Grouped vector attention of Point Transformer V2 (`models/ptv2.py`'s
`GVA`, Pointcept's GroupedVectorAttention) over one packed level.

For row i, its k nearest neighbours j (`level.nbr`, -1 where the cloud has
fewer than k rows), x (M, C) and G groups of C / G channels:
q = ReLU(BN(Linear(x))), k = ReLU(BN(Linear(x))), v = Linear(x); p_ij =
xyz_j - xyz_i; peb = Linear(C, C)(ReLU(BN(Linear(3, C)(p_ij)))); r_ij =
k_j - q_i + peb; w = Linear(G, G)(ReLU(BN(Linear(C, G)(r_ij)))), softmax
over the neighbours per group, times the mask; out_i[g] = sum_j w_ij[g]
(v_j + peb)[g].  A missing neighbour follows pointops' `grouping`: its key,
value and relative position are zero, it enters the softmax's
denominator, and its weight is zeroed after.

- `gva_plain` is the eager form.  CPU tensors, float32 and autograd take
  it.
- `gva` launches `csrc/gva.cu` for CUDA tensors: q, k and v as three
  dense products (`torch.matmul`), then one kernel that computes the rest
  and writes only the output (M, C) float32; the module's parameters go in
  as stored.  It takes bf16, C in `WIDTHS`, C / G = 8 and k in
  `NEIGHBOURS`, and raises on anything else; it never falls back to the
  plain version.  Each launch counts "gva" (`ops._launch`), and the
  kernel adds the call's real neighbour slots, its M k slots and the rows
  it writes as 0 without a product (no neighbour: the capacity's dummy
  rows) to `counters`, three int64 on the device.
- `engages(device, dtype, grad)` is the model's rule: the kernel for a
  CUDA tensor in bf16 with autograd off (the kernel has no backward).

Numerics (both forms): each product takes its operands in the compute
dtype and accumulates in float32, its output and bias rounded to that
dtype (a Linear in that dtype); BatchNorm folded to a scale and a shift
in float32; ReLU, the relation and value sums, the softmax and the
weighted sum in float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
from torch import nn

from wireframe_tpu_torch.ops._launch import check, count, library, on_card

# The widths, the channels a group and the neighbour counts `csrc/gva.cu`
# is built for: every GVA of PTv2's published configuration.
WIDTHS = (48, 96, 192, 384, 512)
GROUP_WIDTH = 8
NEIGHBOURS = (8, 16)
# What the kernel takes, in `csrc/gva.cu`'s order: q, k, v (the products),
# the level's nbr and xyz, the module's parameters, the output and the
# skip counter.
_BN = ("weight", "bias", "running_mean", "running_var")
PARAMS = (("q.bias", "k.bias", "v.bias")
          + tuple(f"q_bn.{n}" for n in _BN) + tuple(f"k_bn.{n}" for n in _BN)
          + ("pe1.weight", "pe1.bias") + tuple(f"pe_bn.{n}" for n in _BN)
          + ("pe2.weight", "pe2.bias", "we1.weight", "we1.bias")
          + tuple(f"we_bn.{n}" for n in _BN) + ("we2.weight", "we2.bias"))
TENSORS = ("q", "k", "v", "nbr", "xyz") + PARAMS + ("out", "counters")


def linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """A Linear in `dtype`: operands in `dtype`, the bias added in it."""
    y = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
    return y if lin.bias is None else y + lin.bias.to(dtype)


def bn_relu(x: torch.Tensor, bn) -> torch.Tensor:
    return torch.relu_(bn(x))


def engages(device: torch.device, dtype, grad: bool) -> bool:
    """Whether the model takes the kernel: a CUDA tensor, compute dtype
    bf16, autograd off (`grad` is `torch.is_grad_enabled()`)."""
    return device.type == "cuda" and dtype == torch.bfloat16 and not grad


def gva_plain(attn, level, x: torch.Tensor, k: int, dt) -> torch.Tensor:
    """(M, C) float32: the GVA module `attn` over `level`'s first k
    neighbours, in PyTorch ops."""
    m, c = x.shape
    g = attn.groups
    idx, has = level.gather[:, :k], level.nbr[:, :k] >= 0
    q = bn_relu(linear(x, attn.q, dt), attn.q_bn)
    key = bn_relu(linear(x, attn.k, dt), attn.k_bn)
    val = linear(x, attn.v, dt).float()
    zero = x.new_zeros((1, c), dtype=torch.float32)
    xyz = torch.cat([level.xyz, level.xyz.new_zeros((1, 3))])
    pos = torch.where(has[..., None], xyz[idx] - level.xyz[:, None],
                      torch.zeros((), device=x.device))
    peb = linear(bn_relu(linear(pos, attn.pe1, dt), attn.pe_bn),
                 attn.pe2, dt).float()
    rel = torch.cat([key, zero])[idx].sub_(q[:, None]).add_(peb)
    val = torch.cat([val, zero])[idx].add_(peb)
    w = linear(bn_relu(linear(rel, attn.we1, dt), attn.we_bn),
               attn.we2, dt).float()
    w = torch.softmax(w, dim=1).mul_(has[..., None])
    out = val.view(m, k, g, c // g).mul_(w[..., None]).sum(1)
    return out.reshape(m, c)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

# At each width, a block's warps and the weight rows (output columns) of a
# ring chunk, pe2's and we1's; the padding of a shared row.  `csrc/gva.cu`
# is checked against these and `gva_plan`'s shared memory at load.
TILES = {48: (8, 16, 16), 96: (8, 32, 16), 192: (8, 32, 32),
         384: (4, 16, 16), 512: (3, 16, 16)}
PAD = 8


def gva_plan(m: int, c: int, groups: int, k: int) -> Dict:
    """What one kernel call launches for M rows at width C, G groups and k
    neighbours: "warps" a block, "rows" (query rows) a block, "blocks"
    and "smem" (dynamic shared memory, bytes)."""
    if c not in WIDTHS or groups * GROUP_WIDTH != c:
        raise ValueError(f"the GVA kernel is built for C in {WIDTHS} with "
                         f"C / G = {GROUP_WIDTH}; got C={c}, G={groups}")
    if k not in NEIGHBOURS:
        raise ValueError(f"the GVA kernel is built for k in {NEIGHBOURS}, "
                         f"not {k}")
    if not 1 <= m < 2 ** 31:
        raise ValueError(f"the GVA kernel takes 1 <= M < 2**31 rows; got {m}")
    warps, ncp, ncw = TILES[c]
    gp = -(-groups // 16) * 16
    ldc, ldg = c + PAD, gp + PAD
    params = 4 * (14 * c + 4 * gp)
    # Parameters, we2, the ring's two stages, then a warp's H and PEB, its
    # 18 gathered rows, 32 row indices and 16 positions.
    smem = (params + 2 * gp * ldg + 2 * 2 * max(ncp, ncw) * ldc
            + warps * (2 * (2 * 16 + 18) * ldc + 32 * 4 + 16 * 3 * 4))
    rows = warps * 16 // k
    return {"warps": warps, "rows": rows, "blocks": -(-m // rows),
            "smem": smem}


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def _check_library(lib) -> None:
    consts = (lib.gva_const(0), lib.gva_const(1))
    if consts != (len(TENSORS), PAD):
        raise RuntimeError(f"csrc/gva.cu takes {consts[0]} tensors, padding "
                           f"{consts[1]}; ops/gva.py says {len(TENSORS)}, "
                           f"{PAD}")
    for c in WIDTHS:
        want = (*TILES[c], gva_plan(1, c, c // GROUP_WIDTH, 16)["smem"])
        built = tuple(lib.gva_shape(c, i) for i in range(4))
        if built != want:
            raise RuntimeError(f"csrc/gva.cu at C={c}: warps, chunk rows "
                               f"and shared memory {built}; ops/gva.py says "
                               f"{want}")


# PARAMS as (submodule, name); the indices of the weights the kernel reads
# 16 bytes at a time.
_NAMES = tuple(tuple(n.split(".")) for n in PARAMS)
_ALIGNED = (PARAMS.index("pe2.weight"), PARAMS.index("we1.weight"))


def _params(attn):
    """The module's tensors in PARAMS order, read from its submodules' own
    tables: `Module.__getattr__` costs about a microsecond a name, on the
    host's path, 17 times a forward."""
    out = []
    for sub, name in _NAMES:
        mod = attn._modules[sub]
        t = mod._parameters.get(name)
        out.append(mod._buffers[name] if t is None else t)
    return out


def _lib():
    return library("gva", {"gva": "P" + "i" * 5 + "P", "gva_const": "i",
                           "gva_shape": "ii"}, _check_library)


def gva(attn, level, x: torch.Tensor, k: int, dt,
        counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`gva_plain`: the plain version for CPU tensors, the kernel for CUDA
    tensors.  `counters`, three int64 on the device, gain the kernel's
    real neighbour slots (rows with index >= 0 among the first k), slots
    (M k) and rows written as 0 without a product."""
    if not on_card(x, "the GVA"):
        return gva_plain(attn, level, x, k, dt)
    return _launch(attn, level, x, k, dt, counters)


def _launch(attn, level, x, k, dt, counters=None):
    if dt != torch.bfloat16:
        raise ValueError(f"the GVA kernel computes in bfloat16, not {dt}")
    m, c = x.shape
    gva_plan(m, c, attn.groups, k)
    nbr, xyz = level.nbr, level.xyz
    if (nbr.dtype != torch.int64 or nbr.dim() != 2 or nbr.shape[0] != m
            or nbr.shape[1] < k or nbr.stride(1) != 1):
        raise ValueError(f"nbr must be (M, >= k) int64 with unit column "
                         f"stride for M = {m}, k = {k}; got "
                         f"{tuple(nbr.shape)} {nbr.dtype}, strides "
                         f"{nbr.stride()}")
    if xyz.shape != (m, 3) or xyz.dtype != torch.float32 \
            or not xyz.is_contiguous():
        raise ValueError(f"xyz must be ({m}, 3) contiguous float32; got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    params = _params(attn)
    if not all(t.dtype == torch.float32 and t.is_contiguous()
               for t in params) or any(params[i].data_ptr() % 16
                                       for i in _ALIGNED):
        raise ValueError("GVA parameters: the kernel reads them as stored, "
                         "contiguous float32, pe2's and we1's weights from "
                         "16-byte aligned starts; got "
                         f"{[(n, t.dtype) for n, t in zip(PARAMS, params)]}")
    if counters is not None and (counters.dtype != torch.int64
                                 or counters.numel() != 3
                                 or not counters.is_contiguous()):
        raise ValueError("counters: three contiguous int64")
    if len({t.get_device() for t in [x, nbr, xyz, *params] + (
            [] if counters is None else [counters])}) != 1:
        raise ValueError("the GVA's tensors must lie on one device")
    xb = x.to(dt)
    qkv = [torch.matmul(xb, lin.weight.to(dt).t())
           for lin in (attn.q, attn.k, attn.v)]
    out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (*qkv, nbr, xyz, *params, out)]
    ptrs.append(None if counters is None else counters.data_ptr())
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(_lib().gva(ctypes.addressof(table), m, nbr.stride(0), k, c,
                     attn.groups, stream), "gva")
    count("gva")
    return out
