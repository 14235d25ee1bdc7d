"""Submanifold sparse convolution of one level's packed rows: Point
Transformer V3's stem and xCPE convs (`models/ptv3.py`'s `SubMConv`).

For M rows x (M, CIN), the level's map nbr (M, K) (`voxel.neighbour_map`:
the row of the voxel at each of the K = size**3 offsets, M where there is
none; built by `csrc/neighbour_map.cu` for CUDA tensors and by
`voxel.neighbour_map_plain` on the CPU) and a weight (COUT, K * CIN), the
offsets' input channels side by side:

    y[r] = sum_o W_o x[nbr[r, o]] + b

- `subm_conv_plain` is the eager form: each chunk of rows gathers its
  neighbours' rows into one (rows, K * CIN) copy, then one GEMM.  CPU
  tensors, autograd and float32 take it.
- `subm_conv` launches `csrc/subm_conv.cu` for CUDA tensors: one kernel
  that loads each row's neighbours straight into the product's operand
  tiles in shared memory and writes no gathered copy.  It takes bf16,
  K <= 125 and the (CIN, COUT) of `SHAPES`, and raises on anything else;
  it never falls back to the plain version.  Each launch counts
  "subm conv" (`ops._launch`).
- `engages(device, dtype, grad, cin, cout, k)` is the model's rule: the
  kernel for a CUDA tensor with autograd off (the kernel has no
  backward), compute dtype bf16 and a shape its plan takes.

The kernel replaces no TPU kernel: the JAX package has no PTv3.  It was
added because the eager gathers took ~110 ms of a ~276 ms batch-128 call;
bytes bound it (each level's rows, map and weights read once, outputs
written once: ~0.5 ms a call on one H100).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from wireframe_tpu_torch.ops._launch import (
    check,
    count,
    library,
    on_card,
    ptr,
)

# Bytes of the gathered neighbour rows one chunk of the plain version holds.
CONV_CHUNK_BYTES = 512 << 20

# The kernel's largest K (size 5) and, for each (CIN, COUT) it is built
# for, the tile of a block: (BM rows, BN output channels, KC depth, warps
# along the rows); every width PTv3's published configuration runs.
# `csrc/subm_conv.cu` is checked against both at load.
MAX_K = 125
SHAPES = {(8, 32): (128, 32, 16, 4), (32, 32): (128, 32, 32, 4),
          (64, 64): (128, 64, 64, 4), (128, 128): (64, 128, 64, 2),
          (256, 256): (64, 128, 64, 2), (512, 512): (64, 128, 64, 2)}


def engages(device: torch.device, dtype, grad: bool, cin: int, cout: int,
            k: int) -> bool:
    """Whether the model takes the kernel: a CUDA tensor, autograd off
    (`grad` is `torch.is_grad_enabled()`), compute dtype bf16, and
    (CIN, COUT, K) that `subm_conv_plan` takes."""
    if device.type != "cuda" or grad or dtype != torch.bfloat16:
        return False
    try:
        subm_conv_plan(1, k, cin, cout)
    except ValueError:
        return False
    return True


def subm_conv_plain(x: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], *, dtype) -> torch.Tensor:
    """(M, COUT) in `dtype`: one gather and one GEMM per chunk of rows,
    operands in `dtype`, the bias added in `dtype`."""
    m, c = x.shape
    k = nbr.shape[1]
    xe = torch.cat([x.to(dtype), x.new_zeros((1, c), dtype=dtype)])
    w = weight.to(dtype).t()
    chunk = max(1024, CONV_CHUNK_BYTES // (k * c * xe.element_size()))
    out = []
    for s in range(0, m, chunk):
        y = torch.matmul(xe[nbr[s:s + chunk]].reshape(-1, k * c), w)
        out.append(y if bias is None else y + bias.to(dtype))
    return torch.cat(out) if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

def subm_conv_plan(m: int, k: int, cin: int, cout: int) -> Dict:
    """What one kernel call launches for M rows, K offsets and (CIN, COUT):
    the tile ("bm", "bn", "kc"), "row_tiles", "col_tiles", "blocks" and
    "chunks" (KC-deep steps of a tile that uses every offset)."""
    if (cin, cout) not in SHAPES:
        raise ValueError(f"the submanifold conv kernel is built for (CIN, "
                         f"COUT) in {sorted(SHAPES)}, not {(cin, cout)}")
    if m < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"the submanifold conv kernel needs M >= 1 and "
                         f"1 <= K <= {MAX_K}; got M={m}, K={k}")
    bm, bn, kc, _ = SHAPES[(cin, cout)]
    rows, cols = -(-m // bm), cout // bn
    return {"bm": bm, "bn": bn, "kc": kc, "row_tiles": rows,
            "col_tiles": cols, "blocks": rows * cols,
            "chunks": -(-k * cin // kc)}


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def _check_library(lib) -> None:
    built = {shape: tuple(lib.subm_conv_tile(*shape, n) for n in range(4))
             for shape in SHAPES}
    if built != SHAPES or lib.subm_conv_tile(0, 0, 4) != MAX_K:
        raise RuntimeError(f"csrc/subm_conv.cu tiles {built} up to K = "
                           f"{lib.subm_conv_tile(0, 0, 4)}; "
                           f"ops/subm_conv.py says {SHAPES} up to {MAX_K}")


def _lib():
    return library("subm_conv", {"subm_conv": "P" * 6 + "i" * 4 + "P",
                                 "subm_conv_tile": "iii"},
                   _check_library)


def subm_conv(x: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], *, dtype,
              counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`subm_conv_plain`: the plain version for CPU tensors, the kernel for
    CUDA tensors.  `counters`, two int64 on the device, gain the kernel's
    (block, offset) steps run and skipped."""
    if not on_card(x, "the submanifold conv"):
        return subm_conv_plain(x, nbr, weight, bias, dtype=dtype)
    return _launch(x, nbr, weight, bias, dtype=dtype, counters=counters)


def _launch(x, nbr, weight, bias, *, dtype, counters=None):
    if dtype != torch.bfloat16:
        raise ValueError(f"the submanifold conv kernel computes in bfloat16, "
                         f"not {dtype}")
    m, cin = x.shape
    cout = weight.shape[0]
    if nbr.dim() != 2 or nbr.shape[0] != m or nbr.dtype != torch.int64:
        raise ValueError(f"nbr must be (M, K) int64 for M = {m}; got "
                         f"{tuple(nbr.shape)} {nbr.dtype}")
    k = nbr.shape[1]
    if weight.shape != (cout, k * cin) or (
            bias is not None and bias.shape != (cout,)):
        raise ValueError(f"weight (COUT, K * CIN) = ({cout}, {k * cin}) and "
                         f"bias (COUT,); got {tuple(weight.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")
    subm_conv_plan(m, k, cin, cout)
    if counters is not None and (counters.dtype != torch.int64
                                 or counters.numel() != 2
                                 or not counters.is_contiguous()):
        raise ValueError("counters: two contiguous int64")
    tensors = [t for t in (nbr, weight, bias, counters) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("the submanifold conv's tensors must lie on one "
                         "device")
    xb = x.to(dtype).contiguous()
    wb = weight.to(dtype).contiguous()
    bb = None if bias is None else bias.to(dtype).contiguous()
    nb = nbr.contiguous()
    y = torch.empty((m, cout), dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(_lib().subm_conv(ptr(xb), ptr(nb), ptr(wb), ptr(bb), ptr(y),
                           ptr(counters), m, k, cin, cout, stream),
          "submanifold conv")
    count("subm conv")
    return y
