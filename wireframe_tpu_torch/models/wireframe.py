"""End-to-end point-cloud -> wireframe model.

Port of `wireframe_tpu/models/wireframe.py:PointCloudToWireframe`:
encoder -> vertex head (the recipe's query decoder, or the parity MLP
head) -> edge head, as one batched, fixed-shape call, with the same
output dict.  As in the JAX module, the head decides the encoder's
kv_pool, whether it keeps point features for the decoder's KV, and the
in-graph z-sort (query head only).  `train=True` takes the encoder's
differentiable chain, turns dropout on (draws from the caller's
generator) and, in prefix slot-mask mode, lets the ground-truth vertex
counts drive the edge head.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from wireframe_tpu_torch.config import ModelConfig
from wireframe_tpu_torch.models.edge_head import EdgePredictor
from wireframe_tpu_torch.models.encoder import PointNetEncoder
from wireframe_tpu_torch.models.vertex_head import VertexPredictor
from wireframe_tpu_torch.models.vertex_query_head import QueryVertexDecoder
from wireframe_tpu_torch.ops.masked_pool import point_validity_mask


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class PointCloudToWireframe(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        if cfg.vertex_head not in ("query", "mlp"):
            raise ValueError(f"unknown vertex_head {cfg.vertex_head!r}")
        query = cfg.vertex_head == "query"
        if cfg.slot_mask_mode not in ("prefix", "existence"):
            raise ValueError(f"unknown slot_mask_mode {cfg.slot_mask_mode!r}")
        self.config = cfg
        dt = torch_dtype(cfg.compute_dtype)
        self.encoder = PointNetEncoder(
            input_dim=cfg.input_dim,
            hidden_dims=tuple(cfg.encoder_hidden_dims),
            output_dim=cfg.encoder_output_dim,
            dtype=dt,
            return_point_features=cfg.return_point_features,
            use_pallas=cfg.use_pallas_encoder,
            pallas_tile=cfg.pallas_tile,
            chain_tile=cfg.pallas_chain_tile,
            chain_backward=cfg.chain_backward,
            kv_pool=cfg.decoder_kv_pool if query else 0,
            point_features_for_kv=query,
        )
        if not query:
            self.vertex_predictor = VertexPredictor(
                global_feature_dim=cfg.encoder_output_dim,
                max_vertices=cfg.max_vertices, vertex_dim=cfg.vertex_dim,
                dtype=dt)
        else:
            self.vertex_decoder = QueryVertexDecoder(
                point_dim=cfg.encoder_output_dim,
                global_dim=cfg.encoder_output_dim,
                max_vertices=cfg.max_vertices,
                dim=cfg.decoder_dim,
                num_layers=cfg.decoder_layers,
                num_heads=cfg.decoder_heads,
                ffn_dim=cfg.decoder_ffn_dim,
                dropout=cfg.decoder_dropout,
                dtype=dt,
                kv_pool=cfg.decoder_kv_pool,
                fused_cross_kv=cfg.decoder_fused_cross_kv,
                scan=cfg.decoder_scan,
                remat=cfg.decoder_remat,
            )
        self.edge_predictor = EdgePredictor(
            vertex_dim=3,
            hidden_dim=cfg.edge_hidden_dim,
            num_heads=cfg.edge_num_heads,
            slot_feature_dim=(cfg.decoder_dim
                              if query and cfg.edge_use_slot_features
                              else 0),
            dtype=dt,
            attn_dropout=cfg.attn_dropout,
            mlp_dropout=cfg.edge_dropout,
        )

    def forward(self, point_cloud: torch.Tensor,
                target_vertex_counts: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """point_cloud: (B, N, input_dim), zero rows are padding;
        target_vertex_counts: (B,) GT counts, which drive the edge head in
        train mode (prefix slot masks); train: training mode; generator:
        the dropout draws."""
        cfg = self.config
        query = cfg.vertex_head == "query"
        if query and cfg.decoder_kv_pool > 1 and not cfg.points_z_sorted:
            # KV pooling maxes over windows of CONSECUTIVE rows: sort the
            # cloud by z first (invalid rows last, stable) so windows are
            # spatially coherent (models/wireframe.py:47-65).
            valid = point_validity_mask(point_cloud)
            zkey = torch.where(valid, point_cloud[..., 2],
                               torch.full_like(point_cloud[..., 2], torch.inf))
            order = torch.argsort(zkey, dim=1, stable=True)
            point_cloud = torch.take_along_dim(point_cloud, order[..., None],
                                               dim=1)

        global_features, pooled, point_features = self.encoder(
            point_cloud, train=train)

        if query:
            kv_feats = point_features
            kv_mask = point_validity_mask(point_cloud)
            kv_pre_pooled = "kv" in pooled
            if kv_pre_pooled:
                kv_feats = pooled["kv"]
                kv_mask = pooled["kv_mask"]
            vertex_out = self.vertex_decoder(
                kv_feats, kv_mask, global_features,
                kv_pre_pooled=kv_pre_pooled, train=train,
                generator=generator)
        else:
            vertex_out = self.vertex_predictor(global_features, pooled)

        if cfg.slot_mask_mode == "existence":
            # Live slots from per-slot existence; the edge head attends
            # over ALL slots (wireframe.py:129-139).
            slot_mask = vertex_out["existence_probabilities"] > 0.5
            attn_slot_mask = torch.ones_like(slot_mask)
            used_counts = torch.sum(slot_mask.to(torch.int32), dim=-1)
        else:
            if train and target_vertex_counts is not None:
                used_counts = target_vertex_counts.to(torch.int32)
            else:
                used_counts = vertex_out["actual_vertex_counts"]
            slot_ids = torch.arange(cfg.max_vertices, dtype=torch.int32,
                                    device=point_cloud.device)
            slot_mask = slot_ids[None, :] < used_counts[:, None]
            attn_slot_mask = slot_mask

        edge_probs, edge_logits, pair_mask = self.edge_predictor(
            vertex_out["vertices"], slot_mask,
            attn_slot_mask=attn_slot_mask,
            slot_features=(vertex_out["slot_features"]
                           if query and cfg.edge_use_slot_features
                           else None),
            train=train, generator=generator)

        out = {
            "vertices": vertex_out["vertices"],
            "existence_logits": vertex_out["existence_logits"],
            "existence_probabilities": vertex_out["existence_probabilities"],
            "actual_vertex_counts": vertex_out["actual_vertex_counts"],
            "used_vertex_counts": used_counts,
            "slot_mask": slot_mask,
            "edge_probs": edge_probs,
            "edge_logits": edge_logits,
            "pair_mask": pair_mask,
            "global_features": global_features,
        }
        if point_features is not None:
            out["point_features"] = point_features
        return out
