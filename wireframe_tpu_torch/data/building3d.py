"""Building3D dataset: host ingest + fixed-shape collation.

The port's copy of `wireframe_tpu/data/building3d.py`, with the same
numpy draws in the same order, so both packages give the same batches
from the same seed.

Per-sample pipeline order matches the reference exactly
(datasets/building3d.py:95-168): channel select (+RGBA/256) -> normalize
cloud AND GT vertices by the full cloud's centroid / max radius -> random
sample to `num_points` -> augment (X/Y flip p=0.5, z-rotation ±5°) ->
per-edge endpoint pairs sorted by descending z.

Collation produces FIXED shapes: points padded to `num_points` (or a
bucket), vertices zero-padded to `max_vertices` slots with a count, and
edge labels scattered onto the static global pair axis (ops/pairs.py).
Augmentation can instead run batched on the device inside the train step
(data/augment.py); with `augment_on_host=False` the host pipeline skips
it.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np

from wireframe_tpu_torch.config import DataConfig
from wireframe_tpu_torch.data.bucketing import z_sort_rows
from wireframe_tpu_torch.io.obj import load_wireframe
from wireframe_tpu_torch.io.xyz import read_xyz, select_features
from wireframe_tpu_torch.ops.pairs import edge_labels_from_edges, num_pairs


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def random_sampling(pc: np.ndarray, num_points: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Down/up-sample to num_points (replace iff fewer points available),
    matching datasets/building3d.py:50-64."""
    replace = pc.shape[0] < num_points
    choices = rng.choice(pc.shape[0], num_points, replace=replace)
    return pc[choices]


def edge_endpoint_array(vertices: np.ndarray,
                        edges: np.ndarray) -> np.ndarray:
    """(n_edges, 2, 3) endpoint coords, per-edge sorted by DESCENDING z.

    Matches datasets/building3d.py:149-152 / evaluate.py:89-99.
    """
    if len(edges) == 0:
        return np.empty((0, 2, 3), dtype=np.float64)
    ev = np.stack((vertices[edges[:, 0]], vertices[edges[:, 1]]), axis=1)
    order = np.argsort(-ev[:, :, 2], axis=1)
    return np.take_along_axis(ev, order[:, :, None], axis=1)


class Building3DDataset:
    """In-memory Building3D corpus (`<root>/<split>/{xyz,wireframe}`) with
    parsed-file caching."""

    def __init__(self, cfg: DataConfig, split: str):
        if split not in ("train", "test"):
            raise ValueError(f"split must be 'train' or 'test', got {split!r}")
        self.cfg = cfg
        self.split = split
        data_dir = os.path.join(cfg.root_dir, split)
        self.pc_files = sorted(glob.glob(os.path.join(data_dir, "xyz", "*.xyz")))
        self.wf_files = [
            p.replace(os.path.sep + "xyz", os.path.sep + "wireframe")
            .replace(".xyz", ".obj")
            for p in self.pc_files
        ]
        self._cache: Dict[int, dict] = {}

    def __len__(self) -> int:
        return len(self.pc_files)

    def load_raw(self, index: int) -> dict:
        """Parse + channel-select + normalize (deterministic, cached)."""
        if index in self._cache:
            return self._cache[index]
        cfg = self.cfg
        pc = read_xyz(self.pc_files[index])
        point_cloud = select_features(pc, cfg.use_color, cfg.use_intensity,
                                      scale_intensity=cfg.scale_intensity)
        wf_vertices, wf_edges = load_wireframe(self.wf_files[index])
        wf_vertices = wf_vertices.copy()

        centroid = np.zeros(3)
        max_distance = 1.0
        if cfg.normalize:
            centroid = np.mean(point_cloud[:, 0:3], axis=0)
            point_cloud[:, 0:3] -= centroid
            max_distance = float(
                np.max(np.linalg.norm(point_cloud[:, 0:3], axis=1)))
            point_cloud[:, 0:3] /= max_distance
            wf_vertices -= centroid
            wf_vertices /= max_distance

        item = {
            "point_cloud": point_cloud,
            "wf_vertices": wf_vertices,
            "wf_edges": wf_edges,
            "centroid": centroid,
            "max_distance": max_distance,
            "scan_idx": int(os.path.splitext(
                os.path.basename(self.pc_files[index]))[0]),
        }
        self._cache[index] = item
        return item

    def get_sample(self, index: int, rng: Optional[np.random.Generator] = None,
                   augment_on_host: Optional[bool] = None) -> dict:
        """One training/eval sample (host arrays, reference field names).

        The draws from `rng` come in a fixed order, the JAX package's:
        the sampling's `choice`, then the two flips, then the angle."""
        cfg = self.cfg
        rng = rng or np.random.default_rng()
        raw = self.load_raw(index)
        point_cloud = raw["point_cloud"].copy()
        wf_vertices = raw["wf_vertices"].copy()
        wf_edges = raw["wf_edges"]

        if cfg.num_points:
            point_cloud = random_sampling(point_cloud, cfg.num_points, rng)

        do_augment = cfg.augment if augment_on_host is None else (
            cfg.augment and augment_on_host)
        if do_augment:
            if rng.random() > 0.5:
                point_cloud[:, 0] *= -1.0
                wf_vertices[:, 0] *= -1.0
            if rng.random() > 0.5:
                point_cloud[:, 1] *= -1.0
                wf_vertices[:, 1] *= -1.0
            rot_angle = (rng.random() * np.pi / 18) - np.pi / 36
            rot = rotz(rot_angle)
            point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot.T
            wf_vertices[:, 0:3] = wf_vertices[:, 0:3] @ rot.T

        if cfg.z_sort_points:
            # After sampling and augmentation: rng.choice returns rows in
            # random order, which would undo an earlier sort.
            point_cloud = z_sort_rows(point_cloud)

        wf_edges_vertices = edge_endpoint_array(wf_vertices, wf_edges)
        wf_centers = (wf_edges_vertices[:, 0, :] + wf_edges_vertices[:, 1, :]) / 2 \
            if len(wf_edges) else np.empty((0, 3))

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "wf_vertices": wf_vertices.astype(np.float32),
            "wf_edges": wf_edges.astype(np.int64),
            "wf_centers": wf_centers.astype(np.float32),
            "wf_edge_number": len(wf_edges),
            "wf_edges_vertices": wf_edges_vertices.reshape(-1, 6).astype(np.float32),
            "centroid": raw["centroid"],
            "max_distance": raw["max_distance"],
            "scan_idx": raw["scan_idx"],
        }


def collate_fixed(samples: Sequence[dict], max_vertices: int) -> dict:
    """Collate host samples into fixed-shape arrays.

    Returns both the dense arrays the train step consumes and the ragged
    host-side ground truth the (numpy) eval stack consumes.
    """
    b = len(samples)
    v = max_vertices
    e = num_pairs(v)
    n = samples[0]["point_clouds"].shape[0]
    d = samples[0]["point_clouds"].shape[1]

    point_clouds = np.zeros((b, n, d), np.float32)
    target_vertices = np.zeros((b, v, 3), np.float32)
    vertex_existence = np.zeros((b, v), np.float32)
    vertex_counts = np.zeros((b,), np.int32)
    edge_labels = np.zeros((b, e), np.float32)

    for i, s in enumerate(samples):
        point_clouds[i] = s["point_clouds"]
        c = min(len(s["wf_vertices"]), v)
        target_vertices[i, :c] = s["wf_vertices"][:c]
        vertex_existence[i, :c] = 1.0
        vertex_counts[i] = c
        edge_labels[i] = edge_labels_from_edges(s["wf_edges"], v)

    return {
        "point_clouds": point_clouds,
        "target_vertices": target_vertices,
        "vertex_existence": vertex_existence,
        "vertex_counts": vertex_counts,
        "edge_labels": edge_labels,
        # ragged host-side ground truth (eval/metrics path)
        "wf_vertices": [s["wf_vertices"] for s in samples],
        "wf_edges": [s["wf_edges"] for s in samples],
        "wf_edges_vertices": [s["wf_edges_vertices"] for s in samples],
        "centroid": np.stack([s["centroid"] for s in samples]),
        "max_distance": np.array([s["max_distance"] for s in samples]),
        "scan_idx": np.array([s["scan_idx"] for s in samples]),
    }


def build_dataset(cfg: DataConfig) -> Dict[str, Building3DDataset]:
    """{train, test} dataset dict (reference datasets/__init__.py:12-18)."""
    return {
        "train": Building3DDataset(cfg, "train"),
        "test": Building3DDataset(cfg, "test"),
    }
