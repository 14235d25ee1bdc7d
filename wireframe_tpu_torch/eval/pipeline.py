"""Fused corpus-scale eval pipeline.

Port of `wireframe_tpu/eval/pipeline.py`.  The plain evaluator runs the
reference's small eval batches and computes each chunk's Hausdorff pass
at its own padded shape, in lockstep with the readback.  Here:

1. One chunk is `batch` clouds, and all of a chunk's device results come
   back in one device -> host copy per array.
2. The pred-edge axis is padded to a FIXED `qmax` and the GT axis to a
   fixed `emax`, so every chunk runs the same shapes.
3. The forward, the live-pair selection, the endpoint construction and
   the Hausdorff matrices are one step (`make_eval_step`), and chunks
   are dispatched `window` ahead of the readback cursor: CUDA runs a
   chunk while the host accumulates the one before and loads the next.

Numerical contract: the counters are bit-identical to the port's own
`evaluate_model(..., device_hausdorff=True)` on the same device at the
same forward batch (`eval.batch_size == batch`).  The on-device edge
selection reproduces `pairs_from_mask` / `pairs_from_slot_mask` (same
pair-table order: a STABLE sort of an integer key, kept pairs first),
the endpoint construction reproduces `edge_endpoint_array`'s
descending-z convention bit for bit (f32 gathers, exact f64 upcast on
the host), and each Hausdorff entry is computed elementwise, independent
of the padding (metrics/hausdorff.py).  The Hausdorff pass runs in
`group`-sample blocks, which bounds its working set (group x qmax x emax
x 20 x 20 float32 per intermediate).  Samples whose kept-pair count
overflows `qmax`, or whose GT edges overflow `emax`, fall back to the
plain path's helpers (counted in `stats`).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from wireframe_tpu_torch.config import Config
from wireframe_tpu_torch.data.building3d import (
    Building3DDataset,
    edge_endpoint_array,
)
from wireframe_tpu_torch.eval.decode import decode_predictions
from wireframe_tpu_torch.eval.distributed import batched_edge_distances
from wireframe_tpu_torch.eval.evaluator import _corner_set, build_model
from wireframe_tpu_torch.metrics.ap_calculator import APCalculator
from wireframe_tpu_torch.metrics.hausdorff import hausdorff_distance_line_torch
from wireframe_tpu_torch.ops.pairs import triu_pairs_np, triu_pairs_on
from wireframe_tpu_torch.utils.platform import resolve_device


def make_eval_step(cfg: Config, qmax: int, emax: int, batch: int,
                   group: int = 8):
    """forward -> live-pair selection -> endpoint construction ->
    (qmax, emax) segment-Hausdorff matrices.

    Returns fn(model, clouds (B, N, D), gt_ev (B, emax, 2, 3)) -> dict of
    tensors on the clouds' device, computed without a host sync.  The
    thresholds are read from `cfg` here, once.
    """
    v = cfg.model.max_vertices
    mode = cfg.model.slot_mask_mode
    ethresh = cfg.eval.edge_confidence_thresh
    vthresh = cfg.eval.vertex_existence_thresh
    if batch % group != 0:
        group = batch

    def step(model, clouds: torch.Tensor, gt_ev: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        pairs = triu_pairs_on(v, clouds.device)       # (E, 2) int64
        with torch.inference_mode():
            preds = model(clouds)
            verts = preds["vertices"]                  # (B, V, 3) f32
            probs = preds["edge_probs"]                # (B, E)
            counts = preds["actual_vertex_counts"]     # (B,)
            exist = preds["existence_probabilities"]   # (B, V)
            if mode == "existence":
                live = exist > vthresh
                pmask = live[:, pairs[:, 0]] & live[:, pairs[:, 1]]
            else:
                # Prefix convention: both endpoints < count (j > i always).
                pmask = pairs[None, :, 1] < counts[:, None]
            keep = pmask & (probs > ethresh)           # (B, E)
            n_keep = keep.sum(dim=1)

            # The first qmax kept pairs in pair-table order: a stable sort
            # of the integer key 0 (kept) / 1 moves the kept pairs to the
            # front in their relative (= pair-table) order, which is
            # `pairs[keep]` of the host decode.
            key = (~keep).to(torch.int32)
            sel = torch.sort(key, dim=1, stable=True).indices[:, :qmax]

            # Endpoints, per edge sorted by DESCENDING z (argsort(-z) over
            # 2 elements: swap iff z0 < z1; ties keep the order).
            pi = pairs[sel]                            # (B, q, 2)
            rows = torch.arange(verts.shape[0], device=verts.device)
            ev = verts[rows[:, None, None], pi]        # (B, q, 2, 3)
            swap = ev[:, :, 0, 2] < ev[:, :, 1, 2]
            ev = torch.where(swap[:, :, None, None], ev.flip(2), ev)

            dist = torch.cat([hausdorff_distance_line_torch(
                ev[g:g + group], gt_ev[g:g + group])
                for g in range(0, batch, group)])
        return {"vertices": verts, "existence": exist, "counts": counts,
                "edge_probs": probs, "sel": sel, "n_keep": n_keep,
                "dist": dist}

    return step


def _build_chunk(cfg: Config, dataset: Building3DDataset,
                 chunk: List[int], batch: int, emax: int):
    """Host inputs for one chunk: padded cloud batch + padded GT edge
    endpoints + the ragged GT the accumulator needs.  Per-sample rng is
    keyed (seed, index) exactly like evaluate_model.  Samples with more GT
    edges than `emax` cannot ride the fixed-shape Hausdorff: they are
    flagged in the returned `em_over` set, and their distances come from
    the plain path's helper."""
    samples = [dataset.get_sample(i, rng=np.random.default_rng(
        (cfg.data.seed, i)), augment_on_host=False) for i in chunk]
    n_real = len(samples)
    while len(samples) < batch:
        samples.append(samples[-1])
    clouds = np.stack([s["point_clouds"] for s in samples])
    gt = []
    em_over = set()
    gt_ev_pad = np.zeros((batch, emax, 2, 3), np.float32)
    for j, s in enumerate(samples[:n_real]):
        gv = s["wf_vertices"]
        ge = s["wf_edges"].astype(np.int64)
        gev = edge_endpoint_array(np.asarray(gv, np.float64), ge)
        if len(ge) > emax:
            em_over.add(j)
        else:
            gt_ev_pad[j, :len(ge)] = gev
        gt.append((gv, ge, gev))
    return samples[:n_real], clouds, gt_ev_pad, gt, em_over


def evaluate_corpus_pipelined(
        cfg: Config, params, dataset: Building3DDataset,
        indices: Optional[List[int]] = None,
        batch: int = 64, qmax: int = 128, emax: int = 64,
        window: int = 3, ap: Optional[APCalculator] = None,
        eval_step=None, verbose: bool = False,
        stats: Optional[dict] = None,
        ap_router=None, device=None) -> Optional[Dict[str, float]]:
    """Corpus eval through the fused fixed-shape pipeline.

    params: flax-path params, as `evaluate_model` takes them.  Pass
    `eval_step` (from make_eval_step with the same shapes) to reuse one.
    `stats`, if given, is filled with {"qmax_overflows": int,
    "emax_overflows": int}: samples whose kept-pair / GT-edge count
    exceeded the fixed pads and took the plain path's helpers (still
    bit-identical).  `ap_router` (callable: dataset index ->
    APCalculator) accumulates each sample into a caller-chosen
    calculator instead of `ap`; the caller then owns the calculators and
    None is returned.  device: "cuda" (default) or "cpu".
    """
    dev = resolve_device(device)
    if ap is None and ap_router is None:
        ap = APCalculator(distance_thresh=cfg.eval.distance_thresh,
                          confidence_thresh=cfg.eval.edge_confidence_thresh)
    if eval_step is None:
        eval_step = make_eval_step(cfg, qmax, emax, batch)
    model = build_model(cfg, params, dev)
    v = cfg.model.max_vertices
    pair_table = triu_pairs_np(v)
    idxs = list(range(len(dataset))) if indices is None else list(indices)
    q_overflows = 0
    e_overflows = 0

    inflight = deque()

    def drain_one():
        nonlocal q_overflows, e_overflows
        chunk_samples, gt, em_over, chunk_idx, out_dev = inflight.popleft()
        out = {k: t.cpu().numpy() for k, t in out_dev.items()}
        for j in range(len(chunk_samples)):
            gv, ge, gev = gt[j]
            slot_verts = out["vertices"][j]
            exist = out["existence"][j]
            live = (exist > cfg.eval.vertex_existence_thresh
                    if cfg.model.slot_mask_mode == "existence" else None)
            n = int(out["n_keep"][j])
            if n > qmax:
                # More kept pairs than the fixed pad: the host decode and
                # the plain path's device Hausdorff helper.
                q_overflows += 1
                dec = decode_predictions(
                    slot_verts, out["edge_probs"][j], int(out["counts"][j]),
                    v, cfg.eval.edge_confidence_thresh, live_mask=live)
                pd_edges = dec["edges"]
                pd_ev = dec["edges_vertices"]
                dist = batched_edge_distances([pd_ev], [gev], device=dev)[0]
            else:
                sel = np.asarray(out["sel"][j][:n], np.int64)
                pd_edges = pair_table[sel].astype(np.int64)
                # Endpoints rebuilt on the host from the f32 slot vertices
                # read back: an exact f64 upcast, as the plain decode's.
                pd_ev = edge_endpoint_array(
                    np.asarray(slot_verts, np.float64), pd_edges)
                if j in em_over:
                    # GT edges overflowed the fixed pad: this row of the
                    # device matrix saw zero padding; recompute it with
                    # the plain path's helper.
                    e_overflows += 1
                    dist = (batched_edge_distances([pd_ev], [gev],
                                                   device=dev)[0]
                            if n else None)
                else:
                    dist = (np.asarray(out["dist"][j][:n, :len(ge)],
                                       np.float64) if n else None)
            corners = _corner_set(cfg, slot_verts, live)
            tgt = ap_router(chunk_idx[j]) if ap_router is not None else ap
            # Dtypes as compute_metrics converts them (GT vertices stay
            # f32: an upcast here changes WED's rounding).
            tgt.accumulate_sample(
                np.asarray(corners).reshape(-1, 3),
                pd_edges.reshape(-1, 2),
                np.asarray(pd_ev).reshape(-1, 2, 3),
                np.asarray(gv).reshape(-1, 3),
                np.asarray(ge).reshape(-1, 2),
                gev.reshape(-1, 2, 3),
                edge_distance=dist)

    for k in range(0, len(idxs), batch):
        chunk = idxs[k:k + batch]
        chunk_samples, clouds, gt_ev_pad, gt, em_over = _build_chunk(
            cfg, dataset, chunk, batch, emax)
        out_dev = eval_step(model, torch.from_numpy(clouds).to(dev),
                            torch.from_numpy(gt_ev_pad).to(dev))
        inflight.append((chunk_samples, gt, em_over, chunk, out_dev))
        while len(inflight) > window:
            drain_one()
    while inflight:
        drain_one()

    if stats is not None:
        stats["qmax_overflows"] = q_overflows
        stats["emax_overflows"] = e_overflows
    if ap_router is not None:
        return None
    return ap.output_accuracy() if verbose else ap.summarize()
