"""Synthetic train batches from a numpy seed.

`make_random_batch` is the port's copy of
`wireframe_tpu/utils/synth.py:make_random_batch` (the same numpy draws,
so both packages get the same arrays from the same seed).
`make_box_building_batch` makes batches that look like the corpus: one
box building per sample, points on its walls and roof, normalised by the
cloud's centroid and max radius as the dataset does, and z-sorted.

Both return host numpy arrays in the batch layout `train_step` consumes:
point_clouds (B, N, D), target_vertices (B, V, 3) zero-padded,
vertex_existence (B, V), vertex_counts (B,), edge_labels (B, E).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from wireframe_tpu_torch.data.bucketing import z_sort_rows
from wireframe_tpu_torch.ops.pairs import num_pairs, pair_slot


def make_random_batch(cfg, batch_size: int, *,
                      num_points: Optional[int] = None, seed: int = 0,
                      edge_density: float = 0.1) -> dict:
    """Random counts-masked batch matching `cfg`'s model/data shapes;
    vertex slots at index >= vertex_counts[i] are zero."""
    n = cfg.data.num_points if num_points is None else num_points
    d, v = cfg.model.input_dim, cfg.model.max_vertices
    e = num_pairs(v)
    r = np.random.default_rng(seed)
    counts = r.integers(4, v + 1, size=batch_size).astype(np.int32)
    slot_live = np.arange(v)[None, :] < counts[:, None]
    return {
        "point_clouds": r.normal(
            size=(batch_size, n, d)).astype(np.float32),
        "target_vertices": (
            r.normal(size=(batch_size, v, 3))
            * slot_live[:, :, None]).astype(np.float32),
        "vertex_existence": slot_live.astype(np.float32),
        "vertex_counts": counts,
        "edge_labels": (
            r.random((batch_size, e)) < edge_density).astype(np.float32),
    }


_BOX_EDGES = np.array([[0, 1], [1, 2], [2, 3], [0, 3],      # floor
                       [4, 5], [5, 6], [6, 7], [4, 7],      # roof
                       [0, 4], [1, 5], [2, 6], [3, 7]])     # walls


def box_building_cloud(rng: np.random.Generator, n: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """A raw (n, 8) cloud of one random box building, as the `.xyz` files
    hold it: points on the 4 walls and the roof (XYZ in metres, from the
    box's corner at the origin), RGBA in [0, 255] and LiDAR intensity;
    and the box's 8 corners (8, 3)."""
    size = rng.uniform([8, 8, 5], [30, 30, 15])
    corners = np.array([[x, y, z] for z in (0.0, size[2])
                        for x, y in ((0, 0), (size[0], 0),
                                     (size[0], size[1]), (0, size[1]))])
    face = rng.integers(0, 5, n)
    p = rng.uniform(0, 1, (n, 3)) * size
    p[face == 0, 0] = 0.0
    p[face == 1, 0] = size[0]
    p[face == 2, 1] = 0.0
    p[face == 3, 1] = size[1]
    p[face == 4, 2] = size[2]
    pc = np.zeros((n, 8))
    pc[:, :3] = p + rng.normal(0, 0.02, (n, 3))
    pc[:, 3:7] = rng.uniform(0, 255, (n, 4))
    pc[:, 7] = rng.uniform(40000, 50000, n)
    return pc, corners


def make_box_building_batch(cfg, batch_size: int, *, seed: int = 0,
                            num_points: Optional[int] = None) -> dict:
    """One box building per sample (`box_building_cloud`): 8 corners,
    12 edges; colour and intensity scaled as the dataset does, cloud and
    corners normalised by the cloud's centroid and max radius, rows
    z-sorted.  Needs the 8-channel input and max_vertices >= 8."""
    n = cfg.data.num_points if num_points is None else num_points
    d, v = cfg.model.input_dim, cfg.model.max_vertices
    if d != 8 or v < 8:
        raise ValueError("box buildings need input_dim 8 and max_vertices "
                         f">= 8, got {d} and {v}")
    rng = np.random.default_rng(seed)
    batch = {
        "point_clouds": np.zeros((batch_size, n, d), np.float32),
        "target_vertices": np.zeros((batch_size, v, 3), np.float32),
        "vertex_existence": np.zeros((batch_size, v), np.float32),
        "vertex_counts": np.full((batch_size,), 8, np.int32),
        "edge_labels": np.zeros((batch_size, num_pairs(v)), np.float32),
    }
    for i in range(batch_size):
        pc, corners = box_building_cloud(rng, n)
        pc[:, 3:7] /= 256.0
        pc[:, 7] /= 65536.0
        centroid = pc[:, :3].mean(axis=0)
        pc[:, :3] -= centroid
        radius = float(np.max(np.linalg.norm(pc[:, :3], axis=1)))
        pc[:, :3] /= radius
        verts = (corners - centroid) / radius
        batch["point_clouds"][i] = z_sort_rows(pc.astype(np.float32))
        batch["target_vertices"][i, :8] = verts
        batch["vertex_existence"][i, :8] = 1.0
        batch["edge_labels"][i, pair_slot(_BOX_EDGES[:, 0], _BOX_EDGES[:, 1],
                                          v)] = 1.0
    return batch


def reference_state_dict(cfg, seed: int = 0) -> dict:
    """Random weights in the layout of the reference's own PyTorch model
    (`trained_model.pth`, which `train.checkpoint.torch_to_flax_params`
    transplants into the parity model of `cfg.model`): every key the
    transplant reads, as float32 numpy arrays from a numpy seed.  Linear
    weights are (out, in) at 1/sqrt(in) scale, the attention's q/k/v
    packed into one (3H, H) `in_proj_weight`; biases and LayerNorm affine
    terms are nonzero so that a slip in any of them shows."""
    m = cfg.model
    r = np.random.default_rng(seed)
    sd = {}

    def linear(name, i, o):
        sd[f"{name}.weight"] = r.normal(size=(o, i)) / np.sqrt(i)
        sd[f"{name}.bias"] = r.normal(size=(o,)) * 0.1

    def norm(name, d):
        sd[f"{name}.weight"] = 1.0 + r.normal(size=(d,)) * 0.1
        sd[f"{name}.bias"] = r.normal(size=(d,)) * 0.1

    prev, c = m.input_dim, m.encoder_output_dim
    for i, h in enumerate(m.encoder_hidden_dims):
        linear(f"encoder.mlp.{4 * i}", prev, h)
        norm(f"encoder.mlp.{4 * i + 1}", h)
        prev = h
    linear(f"encoder.mlp.{4 * len(m.encoder_hidden_dims)}", prev, c)
    linear("encoder.feature_fusion.0", 2 * c, 4 * c)
    norm("encoder.feature_fusion.1", 4 * c)
    linear("encoder.feature_fusion.3", 4 * c, 2 * c)
    norm("encoder.feature_fusion.4", 2 * c)
    linear("encoder.feature_fusion.6", 2 * c, c)
    vp = "vertex_predictor"
    for k, (i, o) in enumerate(((c, 4096), (4096, 2048), (2048, 2048),
                                (2048, 1024)), start=1):
        linear(f"{vp}.vertex_mlp{k}.0", i, o)
        norm(f"{vp}.vertex_mlp{k}.1", o)
    linear(f"{vp}.residual_proj1", c, 2048)
    linear(f"{vp}.residual_proj2", c, 1024)
    linear(f"{vp}.point_pool_proj", 2 * c, c)
    linear(f"{vp}.final_layer", 1024, m.max_vertices * m.vertex_dim)
    h, e = m.edge_hidden_dim, "edge_predictor"
    linear(f"{e}.vertex_proj.0", 3, h // 2)
    norm(f"{e}.vertex_proj.1", h // 2)
    linear(f"{e}.vertex_proj.3", h // 2, h)
    norm(f"{e}.vertex_proj.4", h)
    linear(f"{e}.attention.in_proj", h, 3 * h)
    linear(f"{e}.attention.out_proj", h, h)
    linear(f"{e}.edge_mlp.0", 2 * h + 2 * 3 + 1, h)
    norm(f"{e}.edge_mlp.1", h)
    linear(f"{e}.edge_mlp.4", h, h // 2)
    norm(f"{e}.edge_mlp.5", h // 2)
    linear(f"{e}.edge_mlp.8", h // 2, h // 4)
    linear(f"{e}.edge_mlp.10", h // 4, 1)
    sd[f"{e}.attention.in_proj_weight"] = sd.pop(f"{e}.attention.in_proj.weight")
    sd[f"{e}.attention.in_proj_bias"] = sd.pop(f"{e}.attention.in_proj.bias")
    return {k: v.astype(np.float32) for k, v in sd.items()}
