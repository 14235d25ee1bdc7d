"""Attention-based edge prediction head.

Port of `wireframe_tpu/models/edge_head.py`: embed each slot's
coordinates (plus, with `edge_use_slot_features`, its decoder features)
through Dense/LayerNorm/GELU, one multi-head self-attention layer with a
residual, then per-pair features [f_i ‖ f_j ‖ x_i ‖ x_j ‖ dist] through
an MLP 1031 -> 512 -> 256 -> 128 -> 1 with sigmoid, over the static
(E, 2) pair table of all `max_vertices` slots.

Names are pinned to the flax tree: Dense_0..Dense_5, LayerNorm_0..3,
`attention`; `Dense_2` is the distributive `PairDense`.  In train mode
dropout acts at flax's sites: after the embedding LayerNorm, on the
attention weights (one mask shared by batch and heads), and after each of
the first two pair layers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from wireframe_tpu_torch.models.attention import MultiHeadDotProductAttention
from wireframe_tpu_torch.models.layers import Dense, LayerNorm, dropout, gelu
from wireframe_tpu_torch.ops.pairs import triu_pairs_on


class PairDense(nn.Module):
    """First edge-MLP layer, computed distributively.

        W @ [f_i ‖ f_j ‖ x_i ‖ x_j ‖ d]
          = (f W1 + x W3)[i] + (f W2 + x W4)[j] + d w5 + b

    so the 1031-wide product runs over the V slot rows instead of the
    E = V(V-1)/2 pair rows.  The kernel keeps flax's (in, out) layout,
    split at [:h], [h:2h], [2h:2h+c], [2h+c:2h+2c] and row 2h+2c
    (edge_head.py:65-67).
    """

    def __init__(self, f_dim: int, x_dim: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.f_dim, self.x_dim = f_dim, x_dim
        fan_in = 2 * f_dim + 2 * x_dim + 1
        self.kernel = nn.Parameter(torch.randn(fan_in, features)
                                   / fan_in ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, f, x, dist, i_idx, j_idx):
        h, c = self.f_dim, self.x_dim
        k = self.kernel.to(self.dtype)
        f = f.to(self.dtype)
        x = x.to(self.dtype)
        w_fi, w_fj = k[:h], k[h:2 * h]
        w_ci, w_cj = k[2 * h:2 * h + c], k[2 * h + c:2 * h + 2 * c]
        w_d = k[2 * h + 2 * c]                            # (F,)
        u_i = torch.matmul(f, w_fi) + torch.matmul(x, w_ci)   # (B, V, F)
        u_j = torch.matmul(f, w_fj) + torch.matmul(x, w_cj)
        return (u_i[:, i_idx] + u_j[:, j_idx]
                + dist.to(self.dtype) * w_d + self.bias.to(self.dtype))


class EdgePredictor(nn.Module):
    def __init__(self, vertex_dim: int = 3, hidden_dim: int = 512,
                 num_heads: int = 8, slot_feature_dim: int = 0,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float = 0.0, mlp_dropout: float = 0.0):
        super().__init__()
        h = hidden_dim
        self.dtype = dtype
        self.mlp_dropout = mlp_dropout
        self.Dense_0 = Dense(vertex_dim + slot_feature_dim, h // 2, dtype)
        self.LayerNorm_0 = LayerNorm(h // 2)
        self.Dense_1 = Dense(h // 2, h, dtype)
        self.LayerNorm_1 = LayerNorm(h)
        self.attention = MultiHeadDotProductAttention(h, num_heads, dtype,
                                                      attn_dropout)
        self.Dense_2 = PairDense(h, vertex_dim, h, dtype)
        self.LayerNorm_2 = LayerNorm(h)
        self.Dense_3 = Dense(h, h // 2, dtype)
        self.LayerNorm_3 = LayerNorm(h // 2)
        self.Dense_4 = Dense(h // 2, h // 4, dtype)
        self.Dense_5 = Dense(h // 4, 1, dtype)

    def forward(self, vertices: torch.Tensor, slot_mask: torch.Tensor,
                attn_slot_mask: Optional[torch.Tensor] = None,
                slot_features: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """vertices (B, V, 3); slot_mask (B, V) bool live slots;
        attn_slot_mask (B, V) attention key mask (default slot_mask);
        slot_features optional (B, V, F).  Returns (edge_probs (B, E)
        zeroed outside the pair mask, edge_logits (B, E), pair_mask)."""
        b, v, _ = vertices.shape
        x = vertices.to(self.dtype)
        if attn_slot_mask is None:
            attn_slot_mask = slot_mask
        embed_in = x
        if slot_features is not None:
            embed_in = torch.cat([x, slot_features.to(self.dtype)], dim=-1)

        f = self.LayerNorm_0(self.Dense_0(embed_in))
        f = self.LayerNorm_1(self.Dense_1(gelu(f)))
        f = dropout(f, self.mlp_dropout, train, generator)
        attn_mask = attn_slot_mask[:, None, None, :].expand(b, 1, v, v)
        f = f + self.attention(f, f, attn_mask, train=train,
                               generator=generator)

        pairs = triu_pairs_on(v, vertices.device)
        i_idx, j_idx = pairs[:, 0], pairs[:, 1]
        c1 = x[:, i_idx, :]
        c2 = x[:, j_idx, :]
        # Safe norm, in the model dtype (edge_head.py:153-154).
        d2 = torch.sum(torch.square(c1 - c2), dim=-1, keepdim=True)
        dist = torch.sqrt(d2 + 1e-12)

        y = self.Dense_2(f, x, dist, i_idx, j_idx)
        y = gelu(self.LayerNorm_2(y))
        y = dropout(y, self.mlp_dropout, train, generator)
        y = gelu(self.LayerNorm_3(self.Dense_3(y)))
        y = dropout(y, self.mlp_dropout, train, generator)
        y = gelu(self.Dense_4(y))
        logits = self.Dense_5(y)[..., 0].float()

        # Both endpoints must be live.
        pair_mask = slot_mask[:, i_idx] & slot_mask[:, j_idx]
        probs = torch.sigmoid(logits) * pair_mask.float()
        return probs, logits, pair_mask
