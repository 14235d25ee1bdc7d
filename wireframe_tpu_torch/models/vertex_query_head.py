"""Query-based vertex decoder (DETR-style), the recipe's vertex head.

Port of `wireframe_tpu/models/vertex_query_head.py`:
`max_vertices` learned slot queries cross-attend to the (window-pooled)
per-point features through a pre-LN transformer decoder, and every slot
predicts 3D coordinates plus an existence logit.  In train mode the
decoder's dropout (`decoder_dropout`) acts where flax's does: on both
attentions' weights and after the FFN's GELU.

Every layout of the JAX module is ported, each with its parameter tree:
- unrolled (`block{i}/...`, the shipped recipe's checkpoint layout);
- `fused_cross_kv`: every layer's cross-attention K and V come from the
  shared kv tokens in one product pair (`cross_k_all`, `cross_v_all`),
  and each block runs its cross-attention by hand (`cross_q`,
  `cross_out`) with that branch's own arithmetic (softmax in f32,
  dropout drawn per element);
- `scan`: one block whose parameters are stacked on a leading layer axis
  (`blocks/block/...`, flax `nn.scan`'s tree); layer i runs the block
  with the i-th slice of every parameter, the same per-layer math as the
  unrolled layout;
- `remat`: each block, unrolled or scanned, runs under
  `torch.utils.checkpoint`, so autograd keeps its inputs and the backward
  recomputes the rest.  Dropout draws from the caller's explicit
  generator, which `checkpoint` does not save, so the block is run from a
  copy of the generator's state, and the recomputation replays the same
  masks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from wireframe_tpu_torch.models.attention import (
    MultiHeadDotProductAttention,
    in_dtype,
)
from wireframe_tpu_torch.models.layers import Dense, LayerNorm, dropout, gelu
from wireframe_tpu_torch.ops.masked_pool import window_max_pool


class DecoderBlock(nn.Module):
    """Pre-LN: self-attention over queries, cross-attention to points, FFN.

    With `fused_kv` the block receives its cross-attention K and V already
    projected, (B, N, H, hd) each, and runs the cross-attention itself;
    otherwise it projects the kv tokens through flax's attention."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 fused_kv: bool = False):
        super().__init__()
        self.dropout = dropout
        self.num_heads = num_heads
        self.dtype = dtype
        self.fused_kv = fused_kv
        self.ln_self = LayerNorm(dim)
        self.self_attn = MultiHeadDotProductAttention(dim, num_heads, dtype,
                                                      dropout)
        self.ln_cross = LayerNorm(dim)
        if fused_kv:
            self.cross_q = Dense(dim, dim, dtype)
            self.cross_out = Dense(dim, dim, dtype)
        else:
            self.cross_attn = MultiHeadDotProductAttention(dim, num_heads,
                                                           dtype, dropout)
        self.ln_ffn = LayerNorm(dim)
        self.ffn_in = Dense(dim, ffn_dim, dtype)
        self.ffn_out = Dense(ffn_dim, dim, dtype)

    def _fused_cross(self, h, k, v, kv_mask, train, generator):
        """The fused branch (vertex_query_head.py:58-80): query scaled by
        sqrt(hd) in the dtype, masked logits at the dtype's finfo.min,
        softmax in f32 cast to the dtype, `cross_drop` dropout on each
        (B, H, V, N) weight, output DenseGeneral over (H, hd)."""
        hd = k.shape[-1]
        qh = self.cross_q(h).reshape(*h.shape[:-1], self.num_heads, hd)
        logits = torch.einsum("bvhd,bnhd->bhvn",
                              qh / in_dtype(math.sqrt(hd), self.dtype), k)
        if kv_mask is not None:
            logits = torch.where(
                kv_mask[:, None, None, :], logits,
                torch.full_like(logits, torch.finfo(logits.dtype).min))
        w = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        w = dropout(w, self.dropout, train, generator)
        ctx = torch.einsum("bhvn,bnhd->bvhd", w, v)
        return self.cross_out(ctx.reshape(*ctx.shape[:-2], -1))

    def forward(self, q: torch.Tensor, kv: Sequence[torch.Tensor],
                kv_mask: Optional[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # q: (B, V, D) slot queries; kv: ((B, N, D),) projected point
        # features, or the pre-projected (K, V), (B, N, H, hd) each.
        h = self.ln_self(q)
        q = q + self.self_attn(h, h, train=train, generator=generator)
        h = self.ln_cross(q)
        if self.fused_kv:
            h = self._fused_cross(h, kv[0], kv[1], kv_mask, train,
                                  generator)
        else:
            tokens = kv[0]
            mask = None
            if kv_mask is not None:
                # (B, 1, V, N): every query attends only to valid points.
                mask = kv_mask[:, None, None, :].expand(
                    q.shape[0], 1, q.shape[1], tokens.shape[1])
            h = self.cross_attn(h, tokens, mask, train=train,
                                generator=generator)
        q = q + h
        h = gelu(self.ffn_in(self.ln_ffn(q)))
        h = self.ffn_out(dropout(h, self.dropout, train, generator))
        return q + h


class StackedBlocks(nn.Module):
    """`num_layers` DecoderBlocks as flax `nn.scan` keeps them: one block
    (`block`) whose every parameter carries a leading layer axis."""

    def __init__(self, num_layers: int, **block_kw):
        super().__init__()
        self.block = DecoderBlock(**block_kw)
        for module in self.block.modules():
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, nn.Parameter(
                    p.detach().expand(num_layers, *p.shape).clone()))

    def forward(self, i: int, *args) -> torch.Tensor:
        """Layer i: the block with the i-th slice of every parameter."""
        params = {k: p[i] for k, p in self.block.named_parameters()}
        return torch.func.functional_call(self.block, params, args)


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
                 fused_cross_kv: bool = False, scan: bool = False,
                 remat: bool = False):
        super().__init__()
        self.max_vertices = max_vertices
        self.dim = dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.existence_thresh = existence_thresh
        self.dtype = dtype
        self.kv_pool = kv_pool
        self.dropout = dropout
        self.fused_cross_kv = fused_cross_kv
        self.scan = scan
        self.remat = remat
        self.point_proj = Dense(point_dim, dim, dtype)
        self.point_ln = LayerNorm(dim)
        self.slot_queries = nn.Parameter(torch.randn(max_vertices, dim) * 0.02)
        self.global_proj = Dense(global_dim, dim, dtype)
        if fused_cross_kv:
            # All layers' cross K / V, (D) -> (L, H, hd), in one product each.
            self.cross_k_all = Dense(dim, num_layers * dim, dtype)
            self.cross_v_all = Dense(dim, num_layers * dim, dtype)
        block_kw = dict(dim=dim, num_heads=num_heads, ffn_dim=ffn_dim,
                        dtype=dtype, dropout=dropout, fused_kv=fused_cross_kv)
        if scan:
            self.blocks = StackedBlocks(num_layers, **block_kw)
        else:
            for i in range(num_layers):
                self.add_module(f"block{i}", DecoderBlock(**block_kw))
        self.out_ln = LayerNorm(dim)
        self.coord_head = Dense(dim, 3, dtype)
        self.exist_head = Dense(dim, 1, dtype)

    def _layer(self, i, q, kv, kv_mask, train, generator):
        def run(q, kv_mask, *kv, gen=generator):
            if self.scan:
                return self.blocks(i, q, kv, kv_mask, train, gen)
            return getattr(self, f"block{i}")(q, kv, kv_mask, train, gen)

        if not (self.remat and torch.is_grad_enabled()):
            return run(q, kv_mask, *kv)
        if not (train and self.dropout > 0.0 and generator is not None):
            return checkpoint(run, q, kv_mask, *kv, use_reentrant=False)
        # The forward and the backward's recomputation each draw from a
        # fresh generator set to the state before the block: the same
        # masks.  The caller's generator then moves on as if drawn from.
        start = generator.get_state()
        ran = {}

        def replay(q, kv_mask, *kv):
            gen = torch.Generator(device=generator.device)
            gen.set_state(start)
            ran["gen"] = gen
            return run(q, kv_mask, *kv, gen=gen)

        out = checkpoint(replay, q, kv_mask, *kv, use_reentrant=False)
        generator.set_state(ran["gen"].get_state())
        return out

    def forward(self, point_features: torch.Tensor, point_mask: torch.Tensor,
                global_features: Optional[torch.Tensor] = None,
                kv_pre_pooled: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        if self.kv_pool > 1 and not kv_pre_pooled:
            point_features, point_mask = window_max_pool(
                point_features, point_mask, self.kv_pool)
        b, n = point_features.shape[:2]
        v = self.max_vertices
        kv = self.point_ln(self.point_proj(point_features.to(self.dtype)))
        q = self.slot_queries[None].expand(b, v, self.dim).to(self.dtype)
        if global_features is not None:
            g = self.global_proj(global_features.to(self.dtype))
            q = q + g[:, None, :]
        if self.fused_cross_kv:
            heads = (b, n, self.num_layers, self.num_heads, -1)
            k_all = self.cross_k_all(kv).reshape(heads)
            v_all = self.cross_v_all(kv).reshape(heads)
        for i in range(self.num_layers):
            layer_kv = ((k_all[:, :, i], v_all[:, :, i])
                        if self.fused_cross_kv else (kv,))
            q = self._layer(i, q, layer_kv, point_mask, train, generator)

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
