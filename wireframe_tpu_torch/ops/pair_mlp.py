"""The edge head's pair MLP, from the pair sum to the sigmoid.

`models/edge_head.py`'s `EdgePredictor` computes PairDense's slot-row
products u_i, u_j (B, V, F) over the V slots; everything after them runs
once per pair row, B E = B V (V - 1) / 2 rows:

    y = u_i[:, i] + u_j[:, j] + dist(x_i, x_j) w_d + b_2
    gelu(LayerNorm_2(y)) -> Dense_3 -> gelu(LayerNorm_3) -> Dense_4 -> gelu
      -> Dense_5 -> logits; probs = sigmoid(logits) * pair_mask

- `pair_mlp_plain` is that tail as the port's eager ops (flax's numerics,
  `models/layers.py`), dropout included.  The model runs it whenever
  autograd or dropout needs it, and the op runs it for CPU tensors.
- `pair_mlp` launches `csrc/pair_mlp.cu` for CUDA tensors: one kernel
  from the pair sum to the sigmoid, with no (B, E, .) intermediate in
  device memory.  It takes bf16, F = 256 or 512 and V >= 2, and raises on
  anything else; it never falls back to the plain version.  Each launch
  counts "pair MLP" (`ops._launch`).
- `engages(device, dtype, train, f, v)` is the model's rule: the kernel
  where nothing needs the intermediates (a CUDA tensor, autograd off, no
  dropout), the compute dtype is bf16 and `pair_mlp_plan` takes (F, V).
- `pair_mlp_plan(B, V, F)` is what one call launches.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from wireframe_tpu_torch.models.layers import dense, dropout, gelu, layer_norm
from wireframe_tpu_torch.ops._launch import (
    SMEM_LIMIT,
    SMS,
    check,
    count,
    library,
    on_card,
    ptr,
    row_args,
)
from wireframe_tpu_torch.ops.pairs import num_pairs, triu_pairs_on

# The kernel's constants (`csrc/pair_mlp.cu`, checked at load).
BM = 128                # pair rows a tile
THREADS = 256
KC = 64                 # depth of a weight chunk in the ring
STAGES = 2
PAD = 8                 # bf16 elements of padding a shared-memory row
WIDTHS = (256, 512)     # the widths F the library is built for


class PairMlpParams(NamedTuple):
    """The tail's parameters as the modules hold them (f32, torch layout:
    w3 (F/2, F), w4 (F/4, F/2), w5 (1, F/4))."""

    w_d: torch.Tensor       # (F,) PairDense's distance row
    b2: torch.Tensor        # (F,) PairDense's bias
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    ln3_w: torch.Tensor
    ln3_b: torch.Tensor
    w4: torch.Tensor
    b4: torch.Tensor
    w5: torch.Tensor
    b5: torch.Tensor


def engages(device: torch.device, dtype, train: bool, f: int, v: int
            ) -> bool:
    """Whether the model takes the kernel: CUDA tensors, autograd off
    (`no_grad` or `inference_mode`), compute dtype bf16, no dropout, and
    a width F and V slots that `pair_mlp_plan` takes."""
    if (device.type != "cuda" or torch.is_grad_enabled()
            or dtype != torch.bfloat16 or train):
        return False
    try:
        pair_mlp_plan(1, v, f)
    except ValueError:
        return False
    return True


def pair_mlp_plain(u_i, u_j, x, slot_mask, p: PairMlpParams, *, dtype,
                   rate: float = 0.0, train: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (B, E) f32 zeroed outside the pair mask, logits (B, E) f32,
    pair_mask (B, E) bool) from u_i, u_j (B, V, F) and x (B, V, C) in the
    compute dtype and slot_mask (B, V) bool; dropout at flax's sites."""
    pairs = triu_pairs_on(x.shape[1], x.device)
    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    c1 = x[:, i_idx, :]
    c2 = x[:, j_idx, :]
    # Safe norm, in the model dtype (edge_head.py:153-154).
    d2 = torch.sum(torch.square(c1 - c2), dim=-1, keepdim=True)
    dist = torch.sqrt(d2 + 1e-12)
    y = (u_i[:, i_idx] + u_j[:, j_idx] + dist.to(dtype) * p.w_d.to(dtype)
         + p.b2.to(dtype))
    y = gelu(layer_norm(y, p.ln2_w, p.ln2_b))
    y = dropout(y, rate, train, generator)
    y = gelu(layer_norm(dense(y, p.w3, p.b3, dtype), p.ln3_w, p.ln3_b))
    y = dropout(y, rate, train, generator)
    y = gelu(dense(y, p.w4, p.b4, dtype))
    logits = dense(y, p.w5, p.b5, dtype)[..., 0].float()

    # Both endpoints must be live.
    pair_mask = slot_mask[:, i_idx] & slot_mask[:, j_idx]
    probs = torch.sigmoid(logits) * pair_mask.float()
    return probs, logits, pair_mask


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

def smem_bytes(f: int) -> int:
    """Dynamic shared memory of a block, as `csrc/pair_mlp.cu`'s `Layout`
    places it: the A tile (128 rows of F bf16, padded; H over it later),
    the weight ring (2 chunks of F/2 rows x 64 bf16, padded), the f32
    parameter vector, the rows' pair records and the column warps'
    partials."""
    f2, f4 = f // 2, f // 4
    a_tile = BM * (f + PAD) * 2
    ring = STAGES * f2 * (KC + PAD) * 2
    nvec = 4 * f + 3 * f2 + 2 * f4 + 1
    return a_tile + ring + -(-nvec // 4) * 16 + BM * 16 + 4 * BM * 8


def pair_mlp_plan(b: int, v: int, f: int) -> Dict:
    """What one kernel call launches for B clouds of V slots at width F:
    "rows" (B E pair rows), "tiles" of 128 rows ("last_tile_rows" in the
    last), "grid" (persistent blocks, one an SM, at most the tiles),
    "tiles_per_cta" (the most a block walks), "chunks_per_tile" (64-deep
    chunks of W3 and W4 through the weight ring) and "smem_bytes"."""
    if f not in WIDTHS:
        raise ValueError(f"the pair MLP kernel is built for F in {WIDTHS}, "
                         f"not {f}")
    if b < 1 or v < 2:
        raise ValueError(f"the pair MLP needs B >= 1 and V >= 2; got "
                         f"({b}, {v})")
    rows = b * num_pairs(v)
    tiles = -(-rows // BM)
    grid = min(tiles, SMS)
    return {"rows": rows, "tiles": tiles,
            "last_tile_rows": rows - (tiles - 1) * BM, "grid": grid,
            "tiles_per_cta": -(-tiles // grid),
            "chunks_per_tile": f // KC + f // 2 // KC,
            "smem_bytes": smem_bytes(f)}


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_CONSTS = (BM, THREADS, KC, STAGES, PAD, SMEM_LIMIT)


def _check_library(lib) -> None:
    got = tuple(lib.pair_mlp_const(k) for k in range(len(_CONSTS)))
    if got != _CONSTS:
        raise RuntimeError(f"csrc/pair_mlp.cu's constants {got} are not "
                           f"ops/pair_mlp.py's {_CONSTS}")
    for f in WIDTHS:
        if lib.pair_mlp_smem(f) != smem_bytes(f):
            raise RuntimeError(
                f"csrc/pair_mlp.cu lays out {lib.pair_mlp_smem(f)} bytes "
                f"of shared memory at F={f}; smem_bytes says "
                f"{smem_bytes(f)}")


def _lib():
    return library("pair_mlp", {"pair_mlp": "P" * 10 + "i" * 6 + "P",
                                "pair_mlp_const": "i", "pair_mlp_smem": "i"},
                   _check_library)


class PackedWeights(NamedTuple):
    """The kernel's weights: W3 and W4 in bf16, and one f32 vector
    w_d | b_2 | LayerNorm_2 | b3 | LayerNorm_3 | b4 | w5 | b5, the dense
    layers' terms rounded to bf16 as they use them."""

    w3: torch.Tensor
    w4: torch.Tensor
    vec: torch.Tensor


def pack_weights(p: PairMlpParams) -> PackedWeights:
    bf16 = torch.bfloat16

    def r(t):
        return t.detach().reshape(-1).to(bf16).float()

    def f(t):
        return t.detach().reshape(-1).float()

    vec = torch.cat([r(p.w_d), r(p.b2), f(p.ln2_w), f(p.ln2_b), r(p.b3),
                     f(p.ln3_w), f(p.ln3_b), r(p.b4), r(p.w5), r(p.b5)])
    return PackedWeights(p.w3.detach().to(bf16).contiguous(),
                         p.w4.detach().to(bf16).contiguous(), vec)


def pair_mlp(u_i, u_j, x, slot_mask, p: PairMlpParams, *, dtype
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`pair_mlp_plain` without dropout: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if not on_card(u_i, "the pair MLP"):
        return pair_mlp_plain(u_i, u_j, x, slot_mask, p, dtype=dtype)
    return _launch(u_i, u_j, x, slot_mask, p, dtype=dtype)


def _launch(u_i, u_j, x, slot_mask, p, *, dtype):
    if dtype != torch.bfloat16:
        raise ValueError(f"the pair MLP kernel computes in bfloat16, not "
                         f"{dtype}")
    b, v, f = u_i.shape
    if u_j.shape != u_i.shape or x.shape[:2] != (b, v) or (
            slot_mask.shape != (b, v)):
        raise ValueError(f"u_i, u_j (B, V, F), x (B, V, C), slot_mask (B, V); "
                         f"got {tuple(u_i.shape)}, {tuple(u_j.shape)}, "
                         f"{tuple(x.shape)}, {tuple(slot_mask.shape)}")
    if any(t.dtype != dtype for t in (u_i, u_j, x)) or (
            slot_mask.dtype != torch.bool):
        raise ValueError("u_i, u_j and x in bf16 and a bool slot_mask")
    plan = pair_mlp_plan(b, v, f)
    packed = pack_weights(p)
    if any(t.device != u_i.device for t in (u_j, x, slot_mask, packed.w3,
                                            packed.w4, packed.vec)):
        raise ValueError("the pair MLP's tensors and weights must lie on "
                         "one device")
    kernel = "the pair MLP kernel"
    ui, _ = row_args("u_i", u_i.contiguous(), kernel)
    uj, _ = row_args("u_j", u_j.contiguous(), kernel)
    w3, _ = row_args("W3", packed.w3, kernel)
    w4, _ = row_args("W4", packed.w4, kernel)
    xs, sm = x.contiguous(), slot_mask.contiguous()
    e = num_pairs(v)
    logits = torch.empty((b, e), dtype=torch.float32, device=u_i.device)
    probs = torch.empty_like(logits)
    pair_mask = torch.empty((b, e), dtype=torch.bool, device=u_i.device)
    check(_lib().pair_mlp(
        ui, uj, ptr(xs), ptr(sm), w3, w4, ptr(packed.vec), ptr(logits),
        ptr(probs), ptr(pair_mask), b, v, x.shape[2], f, plan["grid"],
        plan["smem_bytes"],
        torch.cuda.current_stream(u_i.device).cuda_stream), "pair MLP")
    count("pair MLP")
    return probs, logits, pair_mask
