"""Operations of the PTv2 configuration's inference forward, a cloud.

Every product the reference (`reference/ptv2.py`) computes, on the
cloud's real rows (1 multiply-add = 2 operations; norms, activations,
softmax, pooling reductions and the relation and value sums not
counted), from the rows of each level (`reference.ptv2.counts_of`); a
level of n rows has n * min(n, k) real neighbour slots at k:
- the patch embed's projection on level 0's rows;
- each block's fc1, fc3 and the GVA's q, k and v on the level's rows;
  on the real neighbour slots the positional bias MLP (3 -> C -> C), the
  weight encoding (C -> G -> G) and the weighted sum (C a slot);
- grid pooling's Linear on the finer rows, unpooling's two Linears on
  the coarser and the finer rows, the projection to
  `encoder_output_dim` on level 0's rows;
- the recipe after the encoder (fusion MLP, query head over the windows
  of all N rows, edge head) as `counts.forward_flops_per_cloud` counts it,
  its point MLP taken out.
"""

from __future__ import annotations

from typing import Dict

from port_bench import counts


def block_flops(rows: int, c: int, groups: int, k: int) -> float:
    slots = rows * min(rows, k)
    return (2.0 * rows * 5 * c * c
            + 2.0 * slots * (3 * c + c * c + c * groups + groups * groups
                             + c))


def backbone_flops(m: Dict, rec: Dict) -> float:
    """One cloud's backbone; rec: `reference.ptv2.counts_of`'s record."""
    rows = rec["rows"]
    c0 = m["ptv2_patch_embed_channels"]
    enc_c = [c0] + list(m["ptv2_enc_channels"])
    dec_c = list(m["ptv2_dec_channels"]) + [enc_c[-1]]
    total = 2.0 * rows[0] * m["input_dim"] * c0
    total += m["ptv2_patch_embed_depth"] * block_flops(
        rows[0], c0, m["ptv2_patch_embed_groups"],
        m["ptv2_patch_embed_neighbours"])
    for s, depth in enumerate(m["ptv2_enc_depths"]):
        total += 2.0 * rows[s] * enc_c[s] * enc_c[s + 1]
        total += depth * block_flops(rows[s + 1], enc_c[s + 1],
                                     m["ptv2_enc_groups"][s],
                                     m["ptv2_enc_neighbours"][s])
    for s, depth in enumerate(m["ptv2_dec_depths"]):
        total += 2.0 * (rows[s + 1] * dec_c[s + 1] + rows[s] * enc_c[s]) \
            * dec_c[s]
        total += depth * block_flops(rows[s], dec_c[s],
                                     m["ptv2_dec_groups"][s],
                                     m["ptv2_dec_neighbours"][s])
    return total + 2.0 * rows[0] * dec_c[0] * m["encoder_output_dim"]


def forward_flops(m: Dict, rec: Dict, n_points: int) -> float:
    """The whole inference forward of one cloud padded to `n_points`."""
    heads = (counts.forward_flops_per_cloud(m, n_points)
             - counts.point_mlp_flops(m) * n_points)
    return backbone_flops(m, rec) + heads
