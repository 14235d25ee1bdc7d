"""Sharded evaluation with an exact counter merge.

Port of `wireframe_tpu/eval/distributed.py`:

1. `batched_edge_distances`: the pred-vs-GT segment Hausdorff matrices
   of a whole batch in ONE padded device call
   (`hausdorff_distance_line_torch`).
2. `counters_vector` / `calculator_from_vector` / `gather_merge`: an
   APCalculator reduces to a (9,) float64 vector of its raw counters and
   sample count; `gather_merge` all-gathers the vectors of every rank
   over a CPU gloo group (NCCL carries no CPU tensors, and gloo's CUDA
   path has no all-gather) and sums them on the host in rank order:
   the same value on every rank, the integer counters exact.
3. `evaluate_model_sharded`: round-robin shards of the sample indices
   (`parallel.multihost.host_shard_indices`'s arithmetic), one
   APCalculator per shard, merged, then `gather_merge`d.  In a process
   group each rank runs the shards s with s % world == rank.  Within a
   process the merge is exact: each shard keeps every sample's own
   counters, and the merge adds them in dataset-index order, as the
   unsharded run does, so the float counters (corner distances, WED)
   are bit-identical to it too, not only equal up to summation order.
   Across ranks the float counters are each rank's sum added in rank
   order, which may differ from the one-process value in the last bits.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from wireframe_tpu_torch.metrics.ap_calculator import (
    _COUNTER_KEYS,
    APCalculator,
)
from wireframe_tpu_torch.metrics.hausdorff import hausdorff_distance_line_torch
from wireframe_tpu_torch.parallel.collective_audit import all_gather
from wireframe_tpu_torch.parallel.mesh import world
from wireframe_tpu_torch.parallel.multihost import host_shard_indices
from wireframe_tpu_torch.utils.platform import resolve_device


def _pad_to(k: int, mult: int = 8) -> int:
    return max(mult, ((k + mult - 1) // mult) * mult)


def batched_edge_distances(pred_evs: List[np.ndarray],
                           gt_evs: List[np.ndarray],
                           device=None) -> List[Optional[np.ndarray]]:
    """Per-sample (Qi, Ei) float64 Hausdorff matrices, computed in one
    padded float32 batch on `device` ("cuda" by default, see
    `utils.platform.resolve_device`).  Entries do not
    depend on the padding, so slicing recovers the exact per-sample
    matrices.  Samples with no predicted edges return None (the
    corners-only fallback needs no matrix).  Pads round up to multiples
    of 8, as the JAX package's do.
    """
    live = [i for i, p in enumerate(pred_evs) if len(p) > 0]
    out: List[Optional[np.ndarray]] = [None] * len(pred_evs)
    if not live:
        return out
    qm = _pad_to(max(len(pred_evs[i]) for i in live))
    em = _pad_to(max(len(gt_evs[i]) for i in live))
    pp = np.zeros((len(live), qm, 2, 3), np.float32)
    tt = np.zeros((len(live), em, 2, 3), np.float32)
    for j, i in enumerate(live):
        pp[j, :len(pred_evs[i])] = pred_evs[i]
        tt[j, :len(gt_evs[i])] = gt_evs[i]
    dev = resolve_device(device)
    with torch.inference_mode():
        d = hausdorff_distance_line_torch(
            torch.from_numpy(pp).to(dev), torch.from_numpy(tt).to(dev)
        ).cpu().numpy()
    for j, i in enumerate(live):
        out[i] = d[j, :len(pred_evs[i]), :len(gt_evs[i])].astype(np.float64)
    return out


def counters_vector(ap: APCalculator) -> np.ndarray:
    """(len(_COUNTER_KEYS) + 1,) float64: the raw counters, then
    num_samples."""
    return np.asarray(
        [float(ap.ap_dict[k]) for k in _COUNTER_KEYS] + [ap.num_samples],
        np.float64)


def calculator_from_vector(vec: np.ndarray,
                           distance_thresh: float) -> APCalculator:
    ap = APCalculator(distance_thresh=distance_thresh)
    for i, k in enumerate(_COUNTER_KEYS):
        ap.ap_dict[k] = float(vec[i])
    ap.num_samples = int(vec[-1])
    return ap


def gather_merge(ap: APCalculator) -> APCalculator:
    """This rank's counters merged with every other rank's: an all-gather
    of the (9,) counter vectors over a CPU gloo group, then a host sum in
    rank order.  Without a process group (or in a group of one) it is the
    identity."""
    import torch.distributed as dist

    if world()[1] == 1:
        return ap
    # NCCL has no CPU tensors and gloo no CUDA all-gather: a gloo group
    # of the same ranks carries the float64 vector, exactly.
    group = (None if dist.get_backend() == "gloo"
             else dist.new_group(backend="gloo"))
    try:
        vecs = all_gather(torch.from_numpy(counters_vector(ap))[None],
                          group=group).numpy()
    finally:
        if group is not None:
            dist.destroy_process_group(group)
    total = vecs[0].copy()
    for v in vecs[1:]:
        total += v
    merged = calculator_from_vector(total, ap.distance_thresh)
    merged.confidence_thresh = ap.confidence_thresh
    return merged


class _ShardCalculator(APCalculator):
    """An APCalculator that also keeps each sample's own counters, in the
    order it accumulated them."""

    def __init__(self, distance_thresh: float, confidence_thresh: float):
        super().__init__(distance_thresh, confidence_thresh)
        self.rows: List[Dict[str, float]] = []

    def _accumulate_sample(self, *args, **kwargs) -> None:
        total, self.ap_dict = self.ap_dict, {k: 0 for k in _COUNTER_KEYS}
        try:
            super()._accumulate_sample(*args, **kwargs)
            row = self.ap_dict
        finally:
            self.ap_dict = total
        self.rows.append(row)
        for k in _COUNTER_KEYS:
            total[k] += row[k]


def _merge_in_index_order(calcs: Dict[int, _ShardCalculator],
                          n_shards: int, cfg) -> APCalculator:
    """One calculator holding every shard's samples, added in
    dataset-index order (index i is sample i // n_shards of shard
    i % n_shards): the unsharded run's sequence of additions."""
    merged = APCalculator(distance_thresh=cfg.eval.distance_thresh,
                          confidence_thresh=cfg.eval.edge_confidence_thresh)
    order = sorted(s + n_shards * j for s, c in calcs.items()
                   for j in range(len(c.rows)))
    for i in order:
        row = calcs[i % n_shards].rows[i // n_shards]
        for k in _COUNTER_KEYS:
            merged.ap_dict[k] += row[k]
        merged.num_samples += 1
    return merged


def evaluate_model_sharded(cfg, params, dataset,
                           n_shards: Optional[int] = None,
                           forward_fn=None,
                           device_hausdorff: bool = True,
                           verbose: bool = False,
                           pipelined: bool = False,
                           pipeline_kwargs: Optional[dict] = None,
                           ap: Optional[APCalculator] = None,
                           device=None) -> Dict[str, float]:
    """Shard the dataset round-robin, accumulate one APCalculator per
    shard, merge, return the Building3D metric dict.

    n_shards: default the process group's world size (1 without one).
    The per-sample arithmetic is `evaluate_model`'s; only the
    accumulation is partitioned (module docstring: the merge).
    pipelined=False runs `evaluate_model` once per shard;
    pipelined=True makes ONE pass of the fused pipeline
    (`eval.pipeline.evaluate_corpus_pipelined`) over this process's
    shards' samples, routing each sample to its shard's calculator
    (`ap_router`): per-shard pipeline calls would serialise build,
    dispatch and drain per shard.  The pipeline runs its own forward, so
    `forward_fn` raises there, and its distances always come from the
    device.  Pass a fresh `ap` to receive the merged counters.  device:
    "cuda" (default) or "cpu".
    """
    from wireframe_tpu_torch.eval.evaluator import evaluate_model

    if pipelined and forward_fn is not None:
        raise ValueError(
            "pipelined=True runs its own fused forward + Hausdorff step "
            "(eval/pipeline.py) and cannot run a caller-supplied "
            "forward_fn; drop forward_fn or use pipelined=False")
    rank, size = world()
    if n_shards is None:
        n_shards = size
    mine = [s for s in range(n_shards) if s % size == rank]
    shards = {s: host_shard_indices(len(dataset), s, n_shards)
              for s in mine}
    calcs = {s: _ShardCalculator(cfg.eval.distance_thresh,
                                 cfg.eval.edge_confidence_thresh)
             for s, idxs in shards.items() if idxs}
    if pipelined:
        from wireframe_tpu_torch.eval.pipeline import (
            evaluate_corpus_pipelined,
        )

        evaluate_corpus_pipelined(
            cfg, params, dataset,
            indices=sorted(i for idxs in shards.values() for i in idxs),
            ap_router=lambda i: calcs[i % n_shards], device=device,
            **dict(pipeline_kwargs or {}))
    else:
        if forward_fn is None:
            from wireframe_tpu_torch.eval.evaluator import make_forward_fn

            forward_fn = make_forward_fn(cfg, params, device)
        for s, calc in calcs.items():
            evaluate_model(cfg, params, dataset, forward_fn=forward_fn,
                           indices=shards[s], verbose=False,
                           device_hausdorff=device_hausdorff, ap=calc,
                           device=device)
    merged = gather_merge(_merge_in_index_order(calcs, n_shards, cfg))
    if ap is not None:
        merged = ap.merge_counters([merged])
    return merged.output_accuracy() if verbose else merged.summarize()
