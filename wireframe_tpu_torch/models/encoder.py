"""PointNet-style point-cloud encoder.

Port of `wireframe_tpu/models/encoder.py`: a per-point shared MLP
input_dim -> 512 -> 1024 -> 2048 -> 1024 -> 512 (Linear + LayerNorm +
ReLU per stage, plain Linear projection), mask-aware mean + max pooling
over points, and a fusion MLP 1024 -> 2048 -> 1024 -> 512 over the
concatenated pools.

Three compute paths over ONE parameter layout, routed exactly as the JAX
module routes them:
- inference with `use_pallas` and N divisible by the tile: the fused
  kernel K1 (`ops.fused_encoder.fused_point_encoder`);
- training (`train=True`) with `use_pallas` and N divisible by the chain
  tile: the differentiable chain (`ops.chain_grad.differentiable_chain`,
  forward K2, backward K3), which with an eligible kv_pool also emits the
  decoder's pooled KV and the window sums;
- otherwise the plain chain plus masked pools, differentiated by autograd.
The chain's `chain_backward="remat"` flavour (K5) raises
NotImplementedError (ROADMAP.md item A2).
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch
from torch import nn

from wireframe_tpu_torch.models.layers import Dense, LayerNorm
from wireframe_tpu_torch.ops.chain_grad import differentiable_chain
from wireframe_tpu_torch.ops.fused_encoder import (
    fused_point_encoder,
    point_encoder_reference,
)
from wireframe_tpu_torch.ops.masked_pool import (
    masked_max,
    masked_mean,
    point_validity_mask,
)

_kv_pool_warned: set = set()


def _warn_kv_pool_fallback(kv_pool: int, tile: int) -> None:
    """Warn (once per (kv_pool, tile)) when a configured decoder_kv_pool
    cannot be fused into the encoder kernel and demotes to the slower
    separate window pool."""
    key = (kv_pool, tile)
    if key in _kv_pool_warned:
        return
    _kv_pool_warned.add(key)
    logging.getLogger(__name__).warning(
        "decoder_kv_pool=%d cannot be fused into the Pallas encoder at "
        "tile=%d (needs tile %% kv_pool == 0 and a pooled tile that is a "
        "multiple of 8 rows or single-tile); falling back to the slower "
        "XLA window pool", kv_pool, tile)


class FusionMLP(nn.Module):
    """2C -> 4C -> 2C -> C fusion over concatenated (max ‖ mean) pools."""

    def __init__(self, output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = output_dim
        self.Dense_0 = Dense(2 * c, 4 * c, dtype)
        self.LayerNorm_0 = LayerNorm(4 * c)
        self.Dense_1 = Dense(4 * c, 2 * c, dtype)
        self.LayerNorm_1 = LayerNorm(2 * c)
        self.Dense_2 = Dense(2 * c, c, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.LayerNorm_0(self.Dense_0(x)))
        x = torch.relu(self.LayerNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)


class PointNetEncoder(nn.Module):
    """Returns (global_features, pooled_stats, point_features or None).

    Parameters keep the JAX names and layouts: stage{i}_w (I, H),
    stage{i}_b, stage{i}_ln_scale, stage{i}_ln_bias, proj_w (H, C),
    proj_b, and the `fusion` MLP.
    """

    def __init__(self, input_dim: int = 8,
                 hidden_dims: Tuple[int, ...] = (512, 1024, 2048, 1024),
                 output_dim: int = 512, dtype: torch.dtype = torch.float32,
                 return_point_features: bool = False,
                 use_pallas: bool = False, pallas_tile: int = 512,
                 chain_tile: int = 0, chain_backward: str = "remat",
                 kv_pool: int = 0, point_features_for_kv: bool = False):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        self.return_point_features = return_point_features
        self.use_pallas = use_pallas
        self.pallas_tile = pallas_tile
        # Tile of the training chain (0 = pallas_tile); on the card it only
        # decides, as in the JAX module, which shapes take the chain.
        self.chain_tile = chain_tile
        self.chain_backward = chain_backward
        self.kv_pool = kv_pool
        self.point_features_for_kv = point_features_for_kv
        prev = input_dim
        for i, h in enumerate(self.hidden_dims):
            self.register_parameter(
                f"stage{i}_w", nn.Parameter(torch.randn(prev, h) / prev ** 0.5))
            self.register_parameter(f"stage{i}_b",
                                    nn.Parameter(torch.zeros(h)))
            self.register_parameter(f"stage{i}_ln_scale",
                                    nn.Parameter(torch.ones(h)))
            self.register_parameter(f"stage{i}_ln_bias",
                                    nn.Parameter(torch.zeros(h)))
            prev = h
        self.proj_w = nn.Parameter(torch.randn(prev, output_dim) / prev ** 0.5)
        self.proj_b = nn.Parameter(torch.zeros(output_dim))
        self.fusion = FusionMLP(output_dim, dtype)

    def stage_params(self):
        return [tuple(getattr(self, f"stage{i}_{k}")
                      for k in ("w", "b", "ln_scale", "ln_bias"))
                for i in range(len(self.hidden_dims))]

    def forward(self, x: torch.Tensor, train: bool = False):
        # x: (B, N, input_dim); all-zero rows are padding.
        b, n = x.shape[:2]
        tile = (self.chain_tile or self.pallas_tile) if train \
            else self.pallas_tile
        use_pallas = self.use_pallas and (n % tile == 0)
        # In-kernel KV pooling eligibility, as models/encoder.py:147-150.
        kv_pool = self.kv_pool if (
            self.kv_pool > 1 and tile % self.kv_pool == 0
            and ((tile // self.kv_pool) % 8 == 0
                 or tile // self.kv_pool == n // self.kv_pool)) else 0
        if self.kv_pool > 1 and not kv_pool and use_pallas:
            _warn_kv_pool_fallback(self.kv_pool, tile)
        point_features = None
        if use_pallas and train:
            # The differentiable chain (models/encoder.py:156-223).  With
            # kv_pool the decoder consumes only the pooled KV, so the slim
            # flavour never returns the (B, N, C) features.
            need_feats = bool(self.return_point_features) or not kv_pool
            xf = x.float().contiguous()
            mask = point_validity_mask(x)
            outs = differentiable_chain(
                xf, self.stage_params(), self.proj_w, self.proj_b,
                kv_pool=kv_pool, emit_features=need_feats,
                compute_dtype=self.dtype, backward=self.chain_backward)
            if kv_pool:
                if need_feats:
                    feats, pooled_kv, kv_sums = outs
                else:
                    (pooled_kv, kv_sums), feats = outs, None
                kv_mask = torch.any(mask.reshape(b, n // kv_pool, kv_pool),
                                    dim=-1)
                # Global masked pools from the window outputs: the max of
                # the window maxes is the masked max, and the window sums
                # total the masked sum.
                count = torch.clamp_min(
                    torch.sum(mask.float(), dim=-1), 1.0)
                pooled = {
                    "masked_max": masked_max(pooled_kv, kv_mask),
                    "masked_mean": torch.sum(kv_sums, dim=-2)
                    / count[:, None],
                    "kv": pooled_kv,
                    "kv_mask": kv_mask,
                }
                if feats is not None:
                    pooled["mean"] = torch.mean(feats, dim=-2)
                    pooled["max"] = torch.amax(feats, dim=-2)
            else:
                feats = outs
                pooled = {
                    "masked_max": masked_max(feats, mask),
                    "masked_mean": masked_mean(feats, mask),
                    "mean": torch.mean(feats, dim=-2),
                    "max": torch.amax(feats, dim=-2),
                }
            if self.return_point_features or (self.point_features_for_kv
                                              and not kv_pool):
                point_features = feats
        elif use_pallas:
            need_pf = self.return_point_features or (
                self.point_features_for_kv and not kv_pool)
            pooled = fused_point_encoder(
                x.float().contiguous(), self.stage_params(), self.proj_w,
                self.proj_b, tile=tile, return_point_features=need_pf,
                compute_dtype=self.dtype, kv_pool=kv_pool)
            point_features = pooled.pop("point_features", None)
            if kv_pool:
                # The window mask comes from the raw input, outside the
                # kernel (models/encoder.py:235-239).
                mask = point_validity_mask(x)
                pooled["kv"] = pooled.pop("kv_features")
                pooled["kv_mask"] = torch.any(
                    mask.reshape(b, n // kv_pool, kv_pool), dim=-1)
        else:
            mask = point_validity_mask(x)
            feats = point_encoder_reference(
                x, self.stage_params(), self.proj_w, self.proj_b,
                compute_dtype=self.dtype)            # (B, N, C) f32
            pooled = {
                "masked_max": masked_max(feats, mask),
                "masked_mean": masked_mean(feats, mask),
                "mean": torch.mean(feats, dim=-2),
                "max": torch.amax(feats, dim=-2),
            }
            if self.return_point_features or self.point_features_for_kv:
                point_features = feats

        combined = torch.cat([pooled["masked_max"], pooled["masked_mean"]],
                             dim=-1)
        global_features = self.fusion(combined).float()
        return global_features, pooled, point_features
