"""Serving traffic: one client, closed loop, one raw cloud a request.

`serve.WireframePredictor.predict([cloud])` on raw 8-channel clouds in a
UTM-like frame (the frozen generator), the next request sent when the
previous wireframe is back.  Point counts are the mid-quantiles of a
log-uniform law on [min_points, max_points] (the same set for every
seed), so requests fall in every point bucket and the largest are
downsampled.  The predictor loads a port checkpoint that set-up writes
from the seeded weights into a directory under TMPDIR, and serves in
batches of the configuration's `eval.batch_size`.  Each request is timed
from the call to `predict` until its wireframe is returned.

Traffic parameters: clouds (distinct clouds; requests cycle through
them in seeded orders), min_points, max_points, warm_requests_per_bucket
(after the predictor's own warm-up of every bucket), checked_requests (a
sample of the window's requests drawn from the seed, plus the longest
cloud's first request), traced_requests.

The check, per sampled request: the reference prepares the raw cloud
(channels, normalisation, the bucket, the content-keyed downsample or
padding, the z-sort), runs its forward, and compares the raw arrays the
program's forward returned for that request (`common.forward_gaps`);
decode_gap: the largest difference between the returned wireframe and
the one the reference decodes from those arrays (world coordinates;
an edge list that differs counts as infinity).
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time
import zlib
from typing import Dict, List

import numpy as np
import torch

from port_bench import corpus, stats
from port_bench.drivers import common
from port_bench.reference.model import forward as ref_forward


# ---------------------------------------------------------------------------
# The reference's preparation and decode of a request
# ---------------------------------------------------------------------------

def prepare(raw: np.ndarray, data: Dict) -> Dict:
    """Channels, normalisation, bucket, downsample or zero-pad, z-sort:
    the model input (bucket, 8) and the transform back."""
    pc, _, centroid, max_distance = corpus.normalize(
        corpus.select_features(np.asarray(raw, np.float64)))
    pc = pc.astype(np.float32)
    buckets = sorted(data["point_buckets"])
    n = pc.shape[0]
    bucket = next((b for b in buckets if b >= n), buckets[-1])
    if n > bucket:
        digest = zlib.crc32(np.ascontiguousarray(pc, np.float32).tobytes())
        rng = np.random.default_rng(np.random.SeedSequence(
            [data["seed"], digest]))
        x = pc[rng.choice(n, bucket, replace=False)]
    else:
        x = np.zeros((bucket, pc.shape[1]), np.float32)
        x[:n] = pc
    if data["z_sort_points"]:
        x = corpus.z_sort_rows(x)
    return {"x": x, "centroid": centroid, "max_distance": max_distance}


def decode(raw_out: Dict[str, np.ndarray], row: int, ev: Dict,
           prep: Dict):
    """(world vertices (C, 3), edges (K, 2)) of one row of forward
    outputs: the live slots (existence > vertex_existence_thresh),
    compacted in slot order, and the pairs of live slots whose
    probability exceeds edge_confidence_thresh, re-indexed."""
    verts = raw_out["vertices"][row]
    live = raw_out["existence_probabilities"][row] \
        > ev["vertex_existence_thresh"]
    v = verts.shape[0]
    i, j = np.triu_indices(v, k=1)
    keep = (raw_out["edge_probs"][row] > ev["edge_confidence_thresh"]) \
        & live[i] & live[j]
    remap = -np.ones(v, np.int64)
    idx = np.nonzero(live)[0]
    remap[idx] = np.arange(len(idx))
    edges = np.stack([remap[i[keep]], remap[j[keep]]], 1).astype(np.int64)
    world = (np.asarray(verts[idx], np.float64) * prep["max_distance"]
             + prep["centroid"])
    return world, edges.reshape(-1, 2)


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.device, self.spans = cell, device, spans
        self.t = cell.traffic
        self.seed_w, self.seed_data, self.seed_order, self.seed_sample = \
            common.seeds(seed)
        self.kept: List = []
        self.longest = None
        self.last_raw = None

    def setup(self) -> None:
        from wireframe_tpu_torch.bridge import (
            save_port_checkpoint,
            state_dict_to_flax,
        )
        from wireframe_tpu_torch.serve import WireframePredictor

        cfg = common.program_config(self.cell.config)
        self.cfg = cfg
        rng = np.random.default_rng(self.seed_data)
        sizes = corpus.log_uniform_sizes(int(self.t["clouds"]),
                                         int(self.t["min_points"]),
                                         int(self.t["max_points"]))
        self.clouds = [corpus.make_building(rng, n_points=n)[0]
                       for n in sizes]
        self.order_rng = np.random.default_rng(self.seed_order)
        self.order: List[int] = []
        from wireframe_tpu_torch.models.wireframe import (
            PointCloudToWireframe,
        )

        with torch.device("meta"):
            shapes = {k: tuple(v.shape) for k, v in
                      PointCloudToWireframe(cfg.model).state_dict().items()}
        from port_bench.weights import make_weights

        self.weights = make_weights(shapes, self.seed_w, self.device)
        self.ckpt = tempfile.mkdtemp(prefix="port_bench_ckpt_")
        save_port_checkpoint(self.ckpt, state_dict_to_flax(self.weights,
                                                           cfg.model), cfg)
        self.predictor = WireframePredictor(
            self.ckpt, overrides=common.overrides(self.cell.config),
            device=str(self.device))
        forward = self.predictor._forward

        def recorded(x):
            out = forward(x)
            self.last_raw = out
            return out

        self.predictor._forward = recorded
        self.predictor.warmup()
        by_bucket: Dict[int, List[int]] = {}
        for k, c in enumerate(self.clouds):
            b = next((b for b in sorted(cfg.data.point_buckets)
                      if b >= len(c)), max(cfg.data.point_buckets))
            by_bucket.setdefault(b, []).append(k)
        for idxs in by_bucket.values():
            for k in idxs[:int(self.t["warm_requests_per_bucket"])]:
                self.predictor.predict([self.clouds[k]])
        self.sampler = np.random.default_rng(self.seed_sample)

    def _next_cloud(self) -> int:
        if not self.order:
            self.order = list(self.order_rng.permutation(len(self.clouds)))
        return int(self.order.pop(0))

    def _one(self):
        k = self._next_cloud()
        with self.spans.span("predict"):
            t0 = time.perf_counter()
            res = self.predictor.predict([self.clouds[k]])[0]
            t1 = time.perf_counter()
        return k, res, t1 - t0

    def window(self, seconds: float):
        keep = int(self.t["checked_requests"])
        lat: List[float] = []
        biggest = int(np.argmax([len(c) for c in self.clouds]))
        t0 = time.perf_counter()
        failed = 0
        while True:
            try:
                k, res, dt = self._one()
            except Exception as exc:        # a request that fails counts
                print(f"port_bench: request failed: {exc!r}",
                      file=sys.stderr)
                failed += 1
                if time.perf_counter() - t0 >= seconds:
                    break
                continue
            lat.append(dt)
            item = (k, res, self.last_raw)
            if k == biggest and self.longest is None:
                self.longest = item
            n = len(lat)
            if len(self.kept) < keep:
                self.kept.append(item)
            else:
                r = int(self.sampler.integers(n))
                if r < keep:
                    self.kept[r] = item
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        self.lat = lat
        self.stats = {"attempted": len(lat) + failed, "failed": failed,
                      "wall": t1 - t0, "requests": len(lat),
                      "p50_ms": stats.percentile(lat, 50) * 1e3,
                      "p95_ms": stats.percentile(lat, 95) * 1e3}
        return {"serve_p95_ms": self.stats["p95_ms"]}, self.stats

    def segment(self) -> None:
        k = int(self.t["traced_requests"])
        with self.spans.span("segment"):
            for _ in range(k):
                self._one()
        self.stats["segment_units"] = k

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def notes(self) -> List[str]:
        s = self.stats
        lat = self.lat
        tenth = max(1, len(lat) // 10)
        return [f"{s['requests']} requests in {s['wall']:.6f} s, "
                f"median {s['p50_ms']!r} ms, p95 {s['p95_ms']!r} ms "
                f"(nearest rank over all requests)",
                "p95 ms of each tenth of the window's requests: "
                + str([round(1e3 * stats.percentile(lat[i:i + tenth], 95), 3)
                       for i in range(0, len(lat), tenth)])]

    def free(self) -> None:
        del self.predictor
        shutil.rmtree(self.ckpt, ignore_errors=True)
        common.free_cuda()

    def _checked(self) -> List:
        items = list(self.kept)
        if self.longest is not None and all(
                it[0] != self.longest[0] for it in items):
            items.append(self.longest)
        return items

    def _reference(self, k: int, lower: str = ""):
        prep = prepare(self.clouds[k], self.cell.config["data"])
        prec = common.precision(self.cell.config, lower)
        x = torch.from_numpy(prep["x"][None]).to(self.device)
        with torch.no_grad(), prec.matmul_mode():
            return prep, ref_forward(prec, self.weights, self.cell.model, x)

    def program_numbers(self) -> Dict[str, float]:
        ev = self.cell.config["eval"]
        parts = []
        for k, res, raw in self._checked():
            prep, ref = self._reference(k)
            gaps = common.forward_gaps(raw, ref, 1)
            world, edges = decode(raw, 0, ev, prep)
            if (world.shape != res["vertices"].shape
                    or not np.array_equal(edges, res["edges"])):
                gaps["decode_gap"] = float("inf")
            else:
                gaps["decode_gap"] = float(np.abs(
                    world - res["vertices"]).max()) if len(world) else 0.0
            parts.append(gaps)
        return common.merge_max(parts)

    def control_numbers(self) -> Dict[str, float]:
        lower = common.control_precision(self.cell.config)
        parts = []
        for k, _, _ in self._checked():
            _, ref = self._reference(k)
            _, ctl = self._reference(k, lower)
            as_prog = {"vertices": ctl["vertices"].float().cpu().numpy(),
                       "existence_probabilities":
                       ctl["existence_probabilities"].float().cpu().numpy(),
                       "edge_probs": ctl["edge_probs"].float().cpu().numpy(),
                       "actual_vertex_counts": (ctl["existence_probabilities"]
                                                > 0.5).sum(-1).cpu().numpy()}
            # In the program's place the control replaces the forward; the
            # decode of its arrays is the reference's own: no gap.
            parts.append(dict(common.forward_gaps(as_prog, ref, 1),
                              decode_gap=0.0))
        return common.merge_max(parts)

    def check(self):
        return common.checks(self.program_numbers(), self.cell.limits)
