"""Serving path: raw clouds -> world-coordinate wireframes, on one GPU.

Port of `wireframe_tpu/serve.py:WireframePredictor`.  Raw clouds
(1.3k-14k+ points) are channel-selected and normalized exactly like the
training pipeline (centroid + max radius), padded to the smallest
configured point bucket or downsampled to the largest with a per-cloud,
content-keyed RNG, z-sorted on the host when the recipe asks for it, and
served in fixed `serve_batch_size` batches.  Predictions are decoded and
de-normalized back to the input frame, and optionally written as `.obj`.

The encoder runs the fused kernel K1 on the card.  Entry points run on
CUDA unless the caller passes `device="cpu"`.

Usage:
    predictor = WireframePredictor("ckpt_dir")          # port checkpoint
    predictor.warmup()
    results = predictor.predict([cloud1, cloud2])       # raw (N, 8) arrays
    results = predictor.predict_files(["a.xyz"], out_dir="pred")

    python -m wireframe_tpu_torch.serve --checkpoint-dir D --out-dir O a.xyz
"""

from __future__ import annotations

import argparse
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wireframe_tpu_torch.bridge import load_port_checkpoint
from wireframe_tpu_torch.config import apply_saved_model_config, load_config
from wireframe_tpu_torch.data.bucketing import (
    choose_bucket,
    pad_or_sample,
    z_sort_rows,
)
from wireframe_tpu_torch.eval.decode import decode_wireframe
from wireframe_tpu_torch.eval.evaluator import build_model
from wireframe_tpu_torch.io import save_wireframe
from wireframe_tpu_torch.io.xyz import read_xyz, select_features
from wireframe_tpu_torch.utils.platform import resolve_device


class WireframePredictor:
    """Fixed-shape point-cloud -> wireframe inference service."""

    def __init__(self, checkpoint_dir: str,
                 config: Optional[str] = None,
                 overrides: Sequence[str] = (),
                 serve_batch_size: Optional[int] = None,
                 device=None):
        """
        Args:
          checkpoint_dir: port checkpoint (`bridge.save_port_checkpoint`);
            the architecture is read from its config.json.
          config / overrides: optional yaml + `--set`-style overrides.
          serve_batch_size: fixed batch every request is chunked and padded
            to (default cfg.eval.batch_size).
          device: "cuda" (default; raises without a GPU) or "cpu".
        """
        self.device = resolve_device(device)
        cfg = load_config(config, list(overrides))
        params, saved = load_port_checkpoint(checkpoint_dir)
        apply_saved_model_config(cfg, saved)
        self.cfg = cfg
        self.batch_size = int(serve_batch_size or cfg.eval.batch_size)
        self.buckets = tuple(sorted(cfg.data.point_buckets))
        self.model = build_model(cfg, params, self.device)

    def _forward(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            out = self.model(torch.from_numpy(x).to(self.device))
            return {k: out[k].cpu().numpy() for k in (
                "vertices", "edge_probs", "actual_vertex_counts",
                "existence_probabilities")}

    # ------------------------------------------------------------------
    # Input preparation
    # ------------------------------------------------------------------

    def _preprocess(self, raw: np.ndarray) -> dict:
        """Channel-select + normalize one raw cloud; keep the transform."""
        cfg = self.cfg.data
        raw = np.asarray(raw, np.float64)
        if raw.ndim != 2 or raw.shape[1] < 3:
            raise ValueError(f"cloud must be (N, >=3), got {raw.shape}")
        if raw.shape[1] >= 8:
            pc = select_features(raw, cfg.use_color, cfg.use_intensity,
                                 scale_intensity=cfg.scale_intensity)
        else:
            # Geometry-only input: zero-fill the non-XYZ feature channels.
            pc = np.zeros((raw.shape[0], self.cfg.model.input_dim),
                          np.float64)
            pc[:, :3] = raw[:, :3]
        centroid = np.zeros(3)
        max_distance = 1.0
        if cfg.normalize:
            centroid = np.mean(pc[:, 0:3], axis=0)
            pc = pc.copy()
            pc[:, 0:3] -= centroid
            max_distance = float(np.max(np.linalg.norm(pc[:, 0:3], axis=1)))
            max_distance = max(max_distance, 1e-12)
            pc[:, 0:3] /= max_distance
        return {"pc": pc.astype(np.float32), "centroid": centroid,
                "max_distance": max_distance}

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run one dummy batch through every bucket at the serving batch
        size (builds the kernel and warms the allocator)."""
        d = self.cfg.model.input_dim
        for bucket in (buckets or self.buckets):
            dummy = np.zeros((self.batch_size, bucket, d), np.float32)
            dummy[:, 0, 0] = 1.0  # one valid point keeps pools non-degenerate
            self._forward(dummy)

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------

    def batch_plan(self, sizes: Sequence[int]) -> Dict[int, List[List[int]]]:
        """{bucket: [chunk of cloud indices, ...]} for clouds of `sizes`
        points: one model call per chunk."""
        by_bucket: Dict[int, List[int]] = {}
        for i, n in enumerate(sizes):
            by_bucket.setdefault(choose_bucket(n, self.buckets), []).append(i)
        return {bucket: [idxs[k:k + self.batch_size]
                         for k in range(0, len(idxs), self.batch_size)]
                for bucket, idxs in sorted(by_bucket.items())}

    def batch_array(self, pcs: Sequence[np.ndarray],
                    bucket: int) -> np.ndarray:
        """(serve_batch_size, bucket, D) model input from up to
        serve_batch_size preprocessed clouds; unused rows stay zero."""
        x = np.zeros((self.batch_size, bucket, self.cfg.model.input_dim),
                     np.float32)
        for j, pc in enumerate(pcs):
            # Fresh content-keyed RNG per cloud, THEN the z-sort
            # (serve.py:160-170): sorting before the downsample would be
            # undone by rng.choice's random order.
            x[j] = pad_or_sample(pc, bucket, self._cloud_rng(pc))
            if self.cfg.data.z_sort_points:
                x[j] = z_sort_rows(x[j])
        return x

    def predict(self, clouds: Sequence[np.ndarray]) -> List[Dict]:
        """Raw clouds -> wireframes in the input coordinate frame.

        Returns per-cloud dicts: vertices (C, 3) float64 world coords,
        edges (E, 2) int64 into vertices, num_vertices, num_edges.
        """
        prep = [self._preprocess(c) for c in clouds]
        results: List[Optional[Dict]] = [None] * len(prep)
        plan = self.batch_plan([p["pc"].shape[0] for p in prep])
        for bucket, chunks in plan.items():
            for chunk in chunks:
                preds = self._forward(self.batch_array(
                    [prep[i]["pc"] for i in chunk], bucket))
                for j, i in enumerate(chunk):
                    results[i] = self._decode_one(
                        preds["vertices"][j], preds["edge_probs"][j],
                        int(preds["actual_vertex_counts"][j]),
                        preds["existence_probabilities"][j], prep[i])
        return results  # type: ignore[return-value]

    def _cloud_rng(self, pc: np.ndarray) -> np.random.Generator:
        """Deterministic per-request RNG keyed off the cloud's content, so
        the same cloud always gets the same downsample."""
        digest = zlib.crc32(np.ascontiguousarray(pc, np.float32).tobytes())
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.data.seed, digest]))

    def _decode_one(self, verts, probs, count, existence, prep) -> Dict:
        out_verts, edges = decode_wireframe(self.cfg, verts, probs, count,
                                            existence)
        out_verts = (np.asarray(out_verts, np.float64)
                     * prep["max_distance"] + prep["centroid"])
        return {
            "vertices": out_verts,
            "edges": np.asarray(edges, np.int64).reshape(-1, 2),
            "num_vertices": int(len(out_verts)),
            "num_edges": int(len(edges)),
        }

    def predict_files(self, paths: Sequence[str],
                      out_dir: Optional[str] = None) -> List[Dict]:
        """Predict from `.xyz` files; optionally write `.obj` outputs."""
        results = self.predict([read_xyz(p) for p in paths])
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for p, r in zip(paths, results):
                name = os.path.splitext(os.path.basename(p))[0] + ".obj"
                save_wireframe(r["vertices"], r["edges"],
                               os.path.join(out_dir, name))
                r["obj_path"] = os.path.join(out_dir, name)
        return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Predict world-coordinate .obj wireframes from .xyz "
                    "clouds with a port checkpoint.")
    ap.add_argument("xyz", nargs="+", help=".xyz point-cloud files")
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--config", default=None, help="optional yaml")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    predictor = WireframePredictor(args.checkpoint_dir, config=args.config,
                                   overrides=args.overrides,
                                   serve_batch_size=args.batch_size,
                                   device=args.device)
    for r in predictor.predict_files(args.xyz, out_dir=args.out_dir):
        print(f"{r['obj_path']}: {r['num_vertices']} vertices, "
              f"{r['num_edges']} edges")


if __name__ == "__main__":
    main()
