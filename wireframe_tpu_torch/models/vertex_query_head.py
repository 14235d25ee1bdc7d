"""Query-based vertex decoder (DETR-style), the recipe's vertex head.

Port of `wireframe_tpu/models/vertex_query_head.py`:
`max_vertices` learned slot queries cross-attend to the (window-pooled)
per-point features through a pre-LN transformer decoder, and every slot
predicts 3D coordinates plus an existence logit.  In train mode the
decoder's dropout (`decoder_dropout`) acts where flax's does: on both
attentions' weights and after the FFN's GELU.

Only the unrolled, per-layer layout (`block{i}/...`, the shipped
recipe's checkpoint layout) is ported.  `decoder_fused_cross_kv` and
`decoder_scan` change the parameter layout and wait for ROADMAP item A3.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from wireframe_tpu_torch.models.attention import MultiHeadDotProductAttention
from wireframe_tpu_torch.models.layers import Dense, LayerNorm, dropout, gelu
from wireframe_tpu_torch.ops.masked_pool import window_max_pool


class DecoderBlock(nn.Module):
    """Pre-LN: self-attention over queries, cross-attention to points, FFN."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ln_self = LayerNorm(dim)
        self.self_attn = MultiHeadDotProductAttention(dim, num_heads, dtype,
                                                      dropout)
        self.ln_cross = LayerNorm(dim)
        self.cross_attn = MultiHeadDotProductAttention(dim, num_heads, dtype,
                                                       dropout)
        self.ln_ffn = LayerNorm(dim)
        self.ffn_in = Dense(dim, ffn_dim, dtype)
        self.ffn_out = Dense(ffn_dim, dim, dtype)

    def forward(self, q: torch.Tensor, kv: torch.Tensor,
                kv_mask: Optional[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # q: (B, V, D) slot queries; kv: (B, N, D) projected point features.
        h = self.ln_self(q)
        q = q + self.self_attn(h, h, train=train, generator=generator)
        h = self.ln_cross(q)
        mask = None
        if kv_mask is not None:
            # (B, 1, V, N): every query attends only to valid points.
            mask = kv_mask[:, None, None, :].expand(
                q.shape[0], 1, q.shape[1], kv.shape[1])
        q = q + self.cross_attn(h, kv, mask, train=train, generator=generator)
        h = gelu(self.ffn_in(self.ln_ffn(q)))
        h = self.ffn_out(dropout(h, self.dropout, train, generator))
        return q + h


class QueryVertexDecoder(nn.Module):
    """max_vertices learned queries -> cross-attend to points -> per-slot
    coords + existence.  Returns vertices, existence_logits,
    existence_probabilities, actual_vertex_counts and slot_features."""

    def __init__(self, point_dim: int, global_dim: int,
                 max_vertices: int = 64, dim: int = 256,
                 num_layers: int = 4, num_heads: int = 8,
                 ffn_dim: int = 1024, dropout: float = 0.0,
                 existence_thresh: float = 0.5,
                 dtype: torch.dtype = torch.float32, kv_pool: int = 1,
                 fused_cross_kv: bool = False, scan: bool = False):
        super().__init__()
        if fused_cross_kv or scan:
            raise NotImplementedError(
                "decoder_fused_cross_kv / decoder_scan layouts are not "
                "ported yet (ROADMAP.md item A3)")
        self.max_vertices = max_vertices
        self.dim = dim
        self.num_layers = num_layers
        self.existence_thresh = existence_thresh
        self.dtype = dtype
        self.kv_pool = kv_pool
        self.point_proj = Dense(point_dim, dim, dtype)
        self.point_ln = LayerNorm(dim)
        self.slot_queries = nn.Parameter(torch.randn(max_vertices, dim) * 0.02)
        self.global_proj = Dense(global_dim, dim, dtype)
        for i in range(num_layers):
            self.add_module(f"block{i}",
                            DecoderBlock(dim, num_heads, ffn_dim, dtype,
                                         dropout))
        self.out_ln = LayerNorm(dim)
        self.coord_head = Dense(dim, 3, dtype)
        self.exist_head = Dense(dim, 1, dtype)

    def forward(self, point_features: torch.Tensor, point_mask: torch.Tensor,
                global_features: Optional[torch.Tensor] = None,
                kv_pre_pooled: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        if self.kv_pool > 1 and not kv_pre_pooled:
            point_features, point_mask = window_max_pool(
                point_features, point_mask, self.kv_pool)
        b = point_features.shape[0]
        v = self.max_vertices
        kv = self.point_ln(self.point_proj(point_features.to(self.dtype)))
        q = self.slot_queries[None].expand(b, v, self.dim).to(self.dtype)
        if global_features is not None:
            g = self.global_proj(global_features.to(self.dtype))
            q = q + g[:, None, :]
        for i in range(self.num_layers):
            q = getattr(self, f"block{i}")(q, kv, point_mask, train,
                                           generator)

        feats = self.out_ln(q)
        coords = self.coord_head(feats).float()
        existence_logits = self.exist_head(feats)[..., 0].float()
        existence_probs = torch.sigmoid(existence_logits)
        counts = torch.sum((existence_probs > self.existence_thresh)
                           .to(torch.int32), dim=-1)
        return {
            "vertices": coords,
            "existence_logits": existence_logits,
            "existence_probabilities": existence_probs,
            "actual_vertex_counts": counts,
            "slot_features": feats.float(),
        }
