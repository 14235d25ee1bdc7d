"""Operations of the PTv3 configuration's inference forward, a cloud.

Every product the reference (`reference/ptv3.py`) computes, on the
cloud's real rows (1 multiply-add = 2 operations; norms, activations,
pooling reductions and softmax not counted):
- the submanifold convolutions on the neighbour pairs that exist (the
  stem's k=5 map, each stage's k=3 map, one CPE a block), from the
  cloud's own grid coordinates (`reference.ptv3.counts_of`);
- each block's CPE Linear, qkv, output projection and MLP on the stage's
  rows; its attention (QK and AV, every head) on the unpadded segment
  lengths: patches of `ptv3_patch_size` rows and the remainder;
- pooling's Linear on the finer rows, unpooling's two Linears on the
  coarser and the finer rows, the projection to `encoder_output_dim`;
- the recipe after the encoder (fusion MLP, query head over the windows
  of all N rows, edge head) as `counts.forward_flops_per_cloud` counts it,
  its point MLP taken out.
"""

from __future__ import annotations

from typing import Dict

from port_bench import counts
from port_bench.reference.ptv3 import MLP_RATIO


def attention_flops(rows: int, channels: int, patch: int) -> float:
    """QK and AV over the unpadded segments of `rows` serialized rows."""
    full, rest = divmod(rows, patch) if rows > patch else (0, rows)
    return 4.0 * channels * (full * patch * patch + rest * rest)


def block_flops(rows: int, pairs: int, c: int, m: Dict) -> float:
    hidden = c * MLP_RATIO
    dense = c * c + 3 * c * c + c * c + 2 * c * hidden
    return (2.0 * pairs * c * c + 2.0 * rows * dense
            + attention_flops(rows, c, m["ptv3_patch_size"]))


def backbone_flops(m: Dict, rec: Dict) -> float:
    """One cloud's backbone; rec: `reference.ptv3.counts_of`'s record."""
    enc_c, dec_c = m["ptv3_enc_channels"], m["ptv3_dec_channels"]
    rows, pairs = rec["rows"], rec["pairs3"]
    total = 2.0 * rec["pairs5"] * m["input_dim"] * enc_c[0]
    for s, depth in enumerate(m["ptv3_enc_depths"]):
        if s:
            total += 2.0 * rows[s - 1] * enc_c[s - 1] * enc_c[s]
        total += depth * block_flops(rows[s], pairs[s], enc_c[s], m)
    chans = list(dec_c) + [enc_c[-1]]
    for s, depth in enumerate(m["ptv3_dec_depths"]):
        total += 2.0 * (rows[s + 1] * chans[s + 1] + rows[s] * enc_c[s]) \
            * chans[s]
        total += depth * block_flops(rows[s], pairs[s], chans[s], m)
    return total + 2.0 * rows[0] * dec_c[0] * m["encoder_output_dim"]


def forward_flops(m: Dict, rec: Dict, n_points: int) -> float:
    """The whole inference forward of one cloud padded to `n_points`."""
    heads = (counts.forward_flops_per_cloud(m, n_points)
             - counts.point_mlp_flops(m) * n_points)
    return backbone_flops(m, rec) + heads
