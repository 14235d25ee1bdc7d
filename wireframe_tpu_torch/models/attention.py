"""Multi-head dot-product attention with flax.linen's exact semantics.

`flax.linen.MultiHeadDotProductAttention`, as both heads use it:
- q/k/v are DenseGeneral projections with kernel (D, H, hd) and bias
  (H, hd); the output projection has kernel (H, hd, D) and bias (D,).
  Here each is a `Dense` over the flattened heads: weight (H*hd, D) for
  q/k/v and (D, H*hd) for `out`.
- the query is divided by sqrt(hd) rounded to the module dtype, before
  the dot;
- masked logits are filled with the dtype's most negative finite value;
- the softmax runs in the module dtype (flax's
  `force_fp32_for_softmax=False` default);
- in train mode with `dropout_rate > 0` the attention weights are
  multiplied by keep / keep_prob (in the module dtype), with ONE (Q, K)
  keep-mask shared by every batch element and head (flax's
  `broadcast_dropout=True`), drawn from the caller's generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from wireframe_tpu_torch.models.layers import Dense


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
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
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """inputs_q (B, Q, D), inputs_kv (B, K, D); mask broadcastable to
        (B, H, Q, K), True = attend.  Returns (B, Q, D) in the dtype."""
        q = self._heads(self.query(inputs_q))          # (B, Q, H, hd)
        k = self._heads(self.key(inputs_kv))
        v = self._heads(self.value(inputs_kv))
        # sqrt(hd) rounded to the module dtype, as a Python scalar: a
        # tensor built on the host would be a blocking copy every call.
        q = q / in_dtype(math.sqrt(self.head_dim), self.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = torch.where(
                mask, logits,
                torch.full_like(logits, torch.finfo(logits.dtype).min))
        weights = torch.softmax(logits, dim=-1)
        if train and self.dropout_rate > 0.0:
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.rand((1, 1) + weights.shape[-2:],
                              generator=generator,
                              device=weights.device) < keep_prob
            multiplier = keep.to(weights.dtype) / in_dtype(keep_prob,
                                                            weights.dtype)
            weights = weights * multiplier
        x = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(x.reshape(*x.shape[:-2], -1))
