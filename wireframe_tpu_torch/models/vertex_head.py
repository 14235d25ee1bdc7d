"""The reference-parity vertex head: a deep MLP over the global feature.

Port of `wireframe_tpu/models/vertex_head.py` (reference
models/VertexPredictor.py): 512 -> 4096 -> 2048 -> 2048 (+res1) -> 1024
(+res2) -> max_vertices * 4, with the MASKED pooled point features (mean
‖ max) fused into the global feature by a projected residual add, and
the output split into per-slot 3D coordinates and an existence logit.

Parameter names are flax's (`point_pool_proj`, `mlp1..mlp4/{Dense_0,
LayerNorm_0}`, `residual_proj1`, `residual_proj2`, `final_layer`); Dense
computes in the module dtype, LayerNorm in f32, as the flax module does.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from wireframe_tpu_torch.models.layers import Dense, LayerNorm


class MLPBlock(nn.Module):
    """Dense (module dtype) -> LayerNorm (f32) -> ReLU."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, dtype)
        self.LayerNorm_0 = LayerNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.LayerNorm_0(self.Dense_0(x)))


class VertexPredictor(nn.Module):
    def __init__(self, global_feature_dim: int = 512, max_vertices: int = 64,
                 vertex_dim: int = 4, existence_thresh: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = global_feature_dim
        self.max_vertices = max_vertices
        self.vertex_dim = vertex_dim
        self.existence_thresh = existence_thresh
        self.dtype = dtype
        self.point_pool_proj = Dense(2 * c, c, dtype)
        self.mlp1 = MLPBlock(c, 4096, dtype)
        self.mlp2 = MLPBlock(4096, 2048, dtype)
        self.residual_proj1 = Dense(c, 2048, dtype)
        self.mlp3 = MLPBlock(2048, 2048, dtype)
        self.residual_proj2 = Dense(c, 1024, dtype)
        self.mlp4 = MLPBlock(2048, 1024, dtype)
        self.final_layer = Dense(1024, max_vertices * vertex_dim, dtype)

    def forward(self, global_features: torch.Tensor,
                pooled: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """global_features (B, C); pooled: the encoder's pools, of which the
        masked mean and max (each (B, C)) are used.  Returns vertices
        (B, V, 3), existence_logits / existence_probabilities (B, V) and
        actual_vertex_counts (B,)."""
        g = global_features.to(self.dtype)
        pooled_cat = torch.cat([pooled["masked_mean"], pooled["masked_max"]],
                               dim=-1).to(self.dtype)
        enhanced = g + self.point_pool_proj(pooled_cat)
        x = self.mlp2(self.mlp1(enhanced))
        x = self.mlp3(x) + self.residual_proj1(enhanced)
        x = self.mlp4(x) + self.residual_proj2(enhanced)
        out = self.final_layer(x).float().reshape(
            -1, self.max_vertices, self.vertex_dim)
        existence_logits = out[:, :, 3]
        probs = torch.sigmoid(existence_logits)
        return {
            "vertices": out[:, :, :3],
            "existence_logits": existence_logits,
            "existence_probabilities": probs,
            "actual_vertex_counts": torch.sum(
                (probs > self.existence_thresh).to(torch.int32), dim=-1),
        }
