"""Model evaluation over a dataset split with the Building3D AP stack.

Port of `wireframe_tpu/eval/evaluator.py`: batched inference (the model's
inference branch derives vertex counts from existence probabilities),
edge thresholding at `edge_confidence_thresh`, z-descending edge endpoint
construction, and streaming APCalculator accumulation.  The forward is
`train.step.make_forward_fn`'s (under `inference_mode`, as `serve.py`
runs it), so the encoder's fused kernel K1 runs on the card.

Reference parity notes:
- ALL `max_vertices` predicted slots are passed as predicted corners
  (evaluate.py:76 does not filter by existence), so corner precision is
  denominated by the slot count.  Opt out with
  `eval.live_corner_filter=true` (existence slot-mask mode only): only
  live slots — the corner set test.py / serve.py emit — are counted.
- predicted edges are pairs over the first `dynamic_count` slots with
  probability > threshold (PointCloudToWireframe.py:90-92 prefix
  convention on the static pair axis), or over the live slots in
  existence mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from wireframe_tpu_torch.bridge import params_from_flax
from wireframe_tpu_torch.config import Config
from wireframe_tpu_torch.data.bucketing import group_by_bucket
from wireframe_tpu_torch.data.building3d import (
    Building3DDataset,
    collate_fixed,
    edge_endpoint_array,
)
from wireframe_tpu_torch.eval.decode import decode_predictions
from wireframe_tpu_torch.eval.distributed import batched_edge_distances
from wireframe_tpu_torch.metrics.ap_calculator import APCalculator
from wireframe_tpu_torch.models.ptv3 import raise_on_overflow
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.train.step import (
    make_forward_fn as train_forward_fn,
)
from wireframe_tpu_torch.utils.platform import resolve_device

_OUTPUTS = ("vertices", "edge_probs", "actual_vertex_counts",
            "existence_probabilities")


def build_model(cfg: Config, params, device) -> PointCloudToWireframe:
    """The model of `cfg.model` with `params` (flax paths, flat or nested),
    in eval mode on `device`."""
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model.to(device).eval()


def make_forward_fn(cfg: Config, params, device=None
                    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    """fn(clouds (B, N, D) numpy) -> numpy predictions of the inference
    forward (`_OUTPUTS`), run on `device` ("cuda" by default)."""
    dev = resolve_device(device)
    model = build_model(cfg, params, dev)
    model_forward = train_forward_fn(cfg)

    def forward(clouds: np.ndarray) -> Dict[str, np.ndarray]:
        out = model_forward(model, torch.from_numpy(np.ascontiguousarray(
            clouds, np.float32)).to(dev))
        host = {k: out[k].cpu().numpy() for k in _OUTPUTS}
        raise_on_overflow(out)
        return host

    return forward


def _corner_set(cfg: Config, slot_vertices: np.ndarray,
                live: Optional[np.ndarray]) -> np.ndarray:
    """Predicted corners for AP counting: all slots (reference parity) or
    only live slots (`eval.live_corner_filter`, existence mode)."""
    if cfg.eval.live_corner_filter and live is not None:
        return slot_vertices[live]
    return slot_vertices


def predict_bucketed(cfg: Config, params, clouds: List[np.ndarray],
                     forward_fn=None, device=None
                     ) -> List[Dict[str, np.ndarray]]:
    """Inference over RAW (unsampled, variable-size) clouds.

    Clouds are grouped by point-count bucket (cfg.data.point_buckets),
    zero-padded to the bucket (masked out by the encoder), and batched
    per bucket: one forward per bucket present.  Returns per-cloud dicts
    {vertices, edge_probs, count, existence} in input order.
    """
    if forward_fn is None:
        forward_fn = make_forward_fn(cfg, params, device)
    rng = np.random.default_rng(cfg.data.seed)
    groups = group_by_bucket(clouds, cfg.data.point_buckets, rng,
                             z_sort=cfg.data.z_sort_points)
    results: List[Optional[dict]] = [None] * len(clouds)
    for bucket, (idxs, stacked) in sorted(groups.items()):
        preds = forward_fn(stacked)
        verts = preds["vertices"]
        probs = preds["edge_probs"]
        counts = preds["actual_vertex_counts"]
        exist = preds["existence_probabilities"]
        for j, i in enumerate(idxs):
            results[i] = {"vertices": verts[j], "edge_probs": probs[j],
                          "count": int(counts[j]), "existence": exist[j]}
    return results


def _ap_batch(cfg: Config, preds: List[dict], gts: List[tuple]) -> dict:
    """The APCalculator batch of decoded predictions and ragged GT:
    preds[i] {vertices, edge_probs, count, existence}, gts[i] (GT
    vertices, GT edges)."""
    v = cfg.model.max_vertices
    batch = {k: [] for k in ("predicted_vertices", "predicted_edges",
                             "pred_edges_vertices", "wf_vertices",
                             "wf_edges", "wf_edges_vertices")}
    for pred, (gt_vertices, gt_edges) in zip(preds, gts):
        live = (pred["existence"] > cfg.eval.vertex_existence_thresh
                if cfg.model.slot_mask_mode == "existence" else None)
        dec = decode_predictions(
            pred["vertices"], pred["edge_probs"], pred["count"], v,
            cfg.eval.edge_confidence_thresh, live_mask=live)
        gt_edges = gt_edges.astype(np.int64)
        gt_ev = edge_endpoint_array(
            np.asarray(gt_vertices, np.float64), gt_edges)
        batch["predicted_vertices"].append(
            _corner_set(cfg, dec["vertices"], live))
        batch["predicted_edges"].append(dec["edges"])
        batch["pred_edges_vertices"].append(dec["edges_vertices"])
        batch["wf_vertices"].append(gt_vertices)
        batch["wf_edges"].append(gt_edges)
        batch["wf_edges_vertices"].append(gt_ev)
    return batch


def evaluate_model(cfg: Config, params, dataset: Building3DDataset,
                   forward_fn=None,
                   indices: Optional[List[int]] = None,
                   verbose: bool = True,
                   raw_points: bool = False,
                   device_hausdorff: bool = False,
                   ap: Optional[APCalculator] = None,
                   device=None) -> Dict[str, float]:
    """Run inference over `dataset` and return the Building3D metric dict.

    params: flax-path params (a port checkpoint's `params.npz`, or a JAX
    tree).  raw_points=True evaluates on the full unsampled clouds via
    bucketed batching instead of the reference's `num_points` random
    sampling.  device_hausdorff=True computes the pred-vs-GT edge
    Hausdorff matrices in one padded float32 batch on the device
    (`eval.distributed.batched_edge_distances`) instead of per-sample
    float64 numpy.  Pass `ap` to accumulate into an external calculator.
    device: "cuda" (default; raises without a GPU) or "cpu".
    """
    dev = resolve_device(device)
    if forward_fn is None:
        forward_fn = make_forward_fn(cfg, params, dev)
    if ap is None:
        ap = APCalculator(distance_thresh=cfg.eval.distance_thresh,
                          confidence_thresh=cfg.eval.edge_confidence_thresh)
    v = cfg.model.max_vertices
    bs = cfg.eval.batch_size

    # Per-sample rng derived from (seed, index): point sampling for sample
    # i is identical no matter which order / chunk evaluates it.
    def sample_rng(i):
        return np.random.default_rng((cfg.data.seed, i))

    idxs = list(range(len(dataset))) if indices is None else list(indices)
    for k in range(0, len(idxs), bs):
        chunk = idxs[k:k + bs]
        if raw_points:
            saved = dataset.cfg
            dataset.cfg = dataclasses.replace(cfg.data, num_points=0)
            try:
                samples = [dataset.get_sample(i, rng=sample_rng(i),
                                              augment_on_host=False)
                           for i in chunk]
            finally:
                dataset.cfg = saved
            preds = predict_bucketed(
                cfg, params, [s["point_clouds"] for s in samples],
                forward_fn)
        else:
            samples = [dataset.get_sample(i, rng=sample_rng(i),
                                          augment_on_host=False)
                       for i in chunk]
            # Pad a ragged final chunk to the full batch (repeat the last
            # sample) so every forward has one shape; the padded rows are
            # dropped before accumulation.
            n_real = len(samples)
            padded = samples + [samples[-1]] * (bs - n_real)
            out = forward_fn(collate_fixed(padded, v)["point_clouds"])
            preds = [{"vertices": out["vertices"][i],
                      "edge_probs": out["edge_probs"][i],
                      "count": int(out["actual_vertex_counts"][i]),
                      "existence": out["existence_probabilities"][i]}
                     for i in range(n_real)]
        ap_batch = _ap_batch(cfg, preds, [(s["wf_vertices"], s["wf_edges"])
                                          for s in samples])
        if device_hausdorff:
            ap_batch["edge_distance"] = batched_edge_distances(
                ap_batch["pred_edges_vertices"],
                ap_batch["wf_edges_vertices"], device=dev)
        ap.compute_metrics(ap_batch)

    return ap.output_accuracy() if verbose else ap.summarize()
