"""The Python side of `csrc/hopper_gemm.cuh`, the warp-specialised wgmma +
TMA GEMM that K1 (`ops.fused_encoder`) and K2 / K3 / K5
(`ops.chain_grad`) run every product on.

Its constants (the libraries that include the header are held to them
when they load), each stage's LayerNorm mode (`stage_mode`), the dW
K-slices (`split_k`), the two compute dtypes (`kernel_dtype`), the
operands as it reads them (`gemm_operands`) and `chain_plan`, what one
chain call launches from its shapes alone.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from wireframe_tpu_torch.ops._launch import SMS, aligned, pad8, tma_rows

BM, BN, BK = 128, 256, 64   # the wgmma tile of csrc/hopper_gemm.cuh
BK_F32 = 32                 # the 3xTF32 main loop's depth a stage (f32)
STAGES = 4                  # ring stages (bf16)
STAGES_F32 = 3              # ring stages (f32), beside two split tiles
KS = 16                     # k of an f32 split tile: 16 hi + 16 lo a row
F32_FLUSH_K = 2048          # f32: the longest sum the tensor cores keep
MAX_CLUSTER = 8             # CTAs of a LayerNorm cluster (portable limit)
_SPLIT_ROWS = 512           # least rows per K-slice of a split h^T dz
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def kernel_dtype(compute_dtype) -> torch.dtype:
    """The compute dtype of a K1, K2, K3 or K5 call on the card: bfloat16
    or float32, the JAX kernels' two; anything else raises."""
    if compute_dtype not in KERNEL_DTYPES:
        raise ValueError("the encoder-chain kernels (K1, K2, K3, K5) compute "
                         f"in bfloat16 or float32, not {compute_dtype}")
    return compute_dtype


# The 3xTF32 main loop, per form: how TMA brings each f32 operand into
# the ring (as stored: "K-major" or "MN-major") and where it is split
# into TF32 hi + lo.  A is split into registers (wgmma's register-A
# form has no majorness); B, which wgmma reads only from shared memory
# and only K-major in TF32, is split into a K-major hi | lo tile there,
# transposed on the way when it arrives MN-major.  No operand is copied
# in device memory.
F32_SPLIT = {
    "FWD": {"A": ("K-major", "registers"),
            "B": ("MN-major", "shared, transposed")},
    "DH": {"A": ("K-major", "registers"), "B": ("K-major", "shared")},
    "DW": {"A": ("MN-major", "registers"),
           "B": ("MN-major", "shared, transposed")},
}


def split_tile_bytes() -> int:
    """Bytes of one f32 split tile: B's 256 rows of KS TF32 hi and KS lo
    values, K-major, as the 3xTF32 main loop hands them to wgmma."""
    return BN * 2 * KS * 4


def smem_bytes() -> int:
    """Dynamic shared memory of one GEMM launch, as csrc/hopper_gemm.cuh
    reckons it: the largest of the bf16 ring, the epilogue's f32 tile and
    bf16 z tile, and the f32 ring (STAGES_F32 stages of BK_F32, each a
    bf16 stage's bytes) with its two split tiles; the cluster exchange
    slots and the ring's mbarriers, and 1024 bytes to align the ring.
    One size for every launch of either main loop."""
    tile_ld = BN + 8
    stage = (BM * BK + BK * BN) * 2
    epilogue = BM * tile_ld * 4 + BM * tile_ld * 2
    f32 = STAGES_F32 * stage + 2 * split_tile_bytes()
    return 1024 + max(STAGES * stage, epilogue, f32) + 4 * BM * 4 \
        + 2 * STAGES * 8


def ln_cluster(width: int) -> int:
    """CTAs of one fused LayerNorm stage's cluster: ceil(width / BN), for
    a stage that runs in cluster mode (`stage_mode`)."""
    cs = -(-width // BN)
    if not 1 <= cs <= MAX_CLUSTER:
        raise ValueError(f"a chain stage of width {width} needs {cs} CTAs "
                         f"of {BN} columns; a cluster holds 1 to "
                         f"{MAX_CLUSTER}")
    return cs


def stage_mode(width: int):
    """How a stage of `width` columns runs its LayerNorm on the card:
    ("cluster", ctas), fused into its GEMM's epilogue across a cluster of
    ceil(width / 256) CTAs, up to 8 x 256 columns; "split" beyond (the
    GEMM writes the f32 product and `ops.layernorm_rows` normalizes)."""
    if width < 1:
        raise ValueError(f"a chain stage needs a width >= 1, got {width}")
    if width > MAX_CLUSTER * BN:
        return "split"
    return ("cluster", ln_cluster(width))


def split_k(rows: int, i: int, h: int, sms: int = SMS, bk: int = BK
            ) -> List[Tuple[int, int]]:
    """K-slices [start, stop) of dW (i, h) = h^T dz, summed over `rows`:
    enough slices to fill the card once, each a multiple of bk rows (the
    main loop's depth a stage; the last takes the rest), in order.  Their
    partials are summed in this order."""
    tiles = -(-i // BM) * -(-h // BN)
    splits = max(1, min(sms // tiles, rows // _SPLIT_ROWS))
    ksplit = -(-(-(-rows // splits)) // bk) * bk
    return [(s, min(rows, s + ksplit)) for s in range(0, rows, ksplit)]


def gemm_operands(x, stage_params, final_w, final_b, cdt, kernel: str):
    """(layers, final_w, final_b) as the GEMM reads them, for a cloud x
    that `kernel` (K1 or the chain kernels) takes: weights in the compute
    dtype with TMA's rows, biases and LayerNorm terms in f32, 16-byte
    aligned, all on x's device; anything else raises."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{kernel}: the cloud must be a contiguous (B, N, "
                         f"D) float32 array, got {x.dtype} {tuple(x.shape)}")
    prev = x.shape[-1]
    layers = []
    for w, b, g, be in stage_params:
        if w.dim() != 2 or w.shape[0] != prev:
            raise ValueError(f"stage weight {tuple(w.shape)} does not follow "
                             f"width {prev}")
        layers.append((tma_rows(w, cdt),
                       *(aligned(t, torch.float32) for t in (b, g, be))))
        prev = w.shape[1]
    if final_w.dim() != 2 or final_w.shape[0] != prev:
        raise ValueError(f"final weight {tuple(final_w.shape)} does not "
                         f"follow width {prev}")
    fw, fb = tma_rows(final_w, cdt), aligned(final_b, torch.float32)
    if any(t.device != x.device for t in (*sum(layers, ()), fw, fb)):
        raise ValueError(f"{kernel}: the parameters must lie on the cloud's "
                         f"device")
    return layers, fw, fb


def chain_plan(m: int, d: int, widths: Sequence[int], out: int,
               compute_dtype=torch.bfloat16) -> Dict:
    """What one chain call launches, from its shapes alone: the row
    tiles, the padded row strides (elements) of x, each stage's buffers
    and the projection cotangent, each stage's mode (`stage_mode`) and
    cluster (None for a split stage), the K-slices of
    every dW product (x^T dz0, h_k^T dz_k+1, ..., h_last^T g); and for the
    compute dtype the main loop ("wgmma" for bf16, "3xtf32" for f32: wgmma
    on TF32 hi / lo parts), its tile (rows, columns, depth of a stage),
    the ring's stages, the bytes of a ring stage, of the f32 split tiles
    and of a launch's shared memory, where each operand of each form
    (FWD z = h W, DH dh = dz W^T, DW dW = h^T dz) is read and, in f32,
    split ("split"), and the dtype of each buffer: x, h, the stash, the
    cotangents dz and the seed in the compute dtype, K5's recomputed z in
    f32."""
    cdt = kernel_dtype(compute_dtype)
    f32 = cdt == torch.float32
    bk = BK_F32 if f32 else BK
    esize = 4 if f32 else 2
    dims = [d, *widths, out]
    if out < 1:
        raise ValueError(f"the chain's output width must be >= 1, got {out}")
    modes = [stage_mode(w) for w in widths]
    return {"row_tiles": -(-m // BM),
            "x_ld": pad8(d),
            "stage_ld": [pad8(w) for w in widths],
            "out_ld": pad8(out),
            "modes": modes,
            "clusters": [None if mode == "split" else mode[1]
                         for mode in modes],
            "dw_slices": [split_k(m, i, o, bk=bk)
                          for i, o in zip(dims[:-1], dims[1:])],
            "main_loop": "3xtf32" if f32 else "wgmma",
            "tile": (BM, BN, bk),
            "stages": STAGES_F32 if f32 else STAGES,
            "stage_bytes": (BM * bk + bk * BN) * esize,
            "split_bytes": 2 * split_tile_bytes() if f32 else 0,
            "smem_bytes": smem_bytes(),
            "split": F32_SPLIT if f32 else None,
            "dtypes": {"x": cdt, "h": cdt, "stash": cdt, "dz": cdt,
                       "seed": cdt, "recomputed_z": torch.float32}}
