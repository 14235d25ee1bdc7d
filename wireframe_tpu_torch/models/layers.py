"""Dense and LayerNorm with flax.linen's numerics.

- `Dense(dtype=bf16)` casts the input, the kernel AND the bias to the
  compute dtype and adds the bias after the product, in that dtype, as
  `flax.linen.Dense` does.  The weight is stored the torch way, (out, in);
  flax stores (in, out) (`bridge.params_from_flax` transposes).
- `LayerNorm` is `flax.linen.LayerNorm(dtype=float32)`: eps 1e-6 (torch's
  default is 1e-5), statistics in f32 with flax's fast variance
  E[x^2] - E[x]^2 clamped at 0, output in f32.
- `dropout` is `flax.linen.Dropout`: in train mode each element is kept
  with probability 1 - rate and divided by it; the draws come from the
  caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = torch.mean(x, dim=-1, keepdim=True)
        mean2 = torch.mean(torch.square(x), dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu`: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout(rate)` with `deterministic=not train`."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
