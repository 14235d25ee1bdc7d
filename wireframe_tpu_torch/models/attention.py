"""Multi-head dot-product attention with flax.linen's exact semantics.

`flax.linen.MultiHeadDotProductAttention` (inference, no dropout), as
both heads use it:
- q/k/v are DenseGeneral projections with kernel (D, H, hd) and bias
  (H, hd); the output projection has kernel (H, hd, D) and bias (D,).
  Here each is a `Dense` over the flattened heads: weight (H*hd, D) for
  q/k/v and (D, H*hd) for `out`.
- the query is divided by sqrt(hd) rounded to the module dtype, before
  the dot;
- masked logits are filled with the dtype's most negative finite value;
- the softmax runs in the module dtype (flax's
  `force_fp32_for_softmax=False` default).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from wireframe_tpu_torch.models.layers import Dense


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.num_heads, self.head_dim)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs_q (B, Q, D), inputs_kv (B, K, D); mask broadcastable to
        (B, H, Q, K), True = attend.  Returns (B, Q, D) in the dtype."""
        q = self._heads(self.query(inputs_q))          # (B, Q, H, hd)
        k = self._heads(self.key(inputs_kv))
        v = self._heads(self.value(inputs_kv))
        depth = torch.tensor(math.sqrt(self.head_dim),
                             dtype=torch.float32).to(self.dtype)
        q = q / depth.to(q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = torch.where(
                mask, logits,
                torch.full_like(logits, torch.finfo(logits.dtype).min))
        weights = torch.softmax(logits, dim=-1)
        x = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(x.reshape(*x.shape[:-2], -1))
