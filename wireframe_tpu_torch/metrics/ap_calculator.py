"""Streaming Building3D wireframe metrics (ACO, corner/edge P/R/F1, WED).

The port's copy of `wireframe_tpu/metrics/ap_calculator.py` (numpy and scipy only).

Counting rules match eval/ap_calculator.py:107-307 exactly (with its
hot-path debug prints dropped — quirk 7):

Per sample with predicted edges:
  1. Hungarian-match predicted vs GT edges on the sampled segment
     Hausdorff matrix; matches within `distance_thresh` are positive edges.
  2. TP corners = unique endpoint corners of positive edges, plus
     Hungarian-matched leftover corners within threshold.
  3. Corner offset accumulates the matched leftover-corner distances plus,
     for each unique positive-edge corner, its nearest-GT-corner distance.
  4. WED via `graph_edit_distance` seeded with the accumulated offsets
     (reproducing the reference's GT-derived submission construction).
Per sample without predicted edges: corners-only Hungarian fallback,
WED = 1 (ap_calculator.py:244-260).

`confidence_thresh` is stored for API parity but, as in the reference
(quirk 8), thresholding happens in callers (default 0.5).

Divergence (documented): `average_wed` divides by the number of samples
accumulated; the reference divides by the LAST batch's size
(ap_calculator.py:276 + the `self.batch_size` overwrite at :140), which
under-counts whenever there is more than one batch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from wireframe_tpu_torch.metrics.hausdorff import hausdorff_distance_line
from wireframe_tpu_torch.metrics.wed import (
    compute_edge_indices,
    graph_edit_distance,
    setdiff_rows,
)


def _cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    diff = a[:, None, :] - b[None, :, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


_COUNTER_KEYS = ("tp_corners", "tp_fp_corners", "tp_fn_corners", "distance",
                 "tp_edges", "tp_fp_edges", "tp_fn_edges", "wed")


class APCalculator:
    def __init__(self, distance_thresh: float = 0.1,
                 confidence_thresh: float = 0.7):
        self.distance_thresh = distance_thresh
        self.confidence_thresh = confidence_thresh
        self.reset()

    def reset(self) -> None:
        self.ap_dict: Dict[str, float] = {k: 0 for k in _COUNTER_KEYS}
        self.num_samples = 0

    def compute_metrics(self, batch: Dict[str, List[np.ndarray]]) -> None:
        """Accumulate one batch.  Batch keys (each a length-B sequence):
        predicted_vertices (Pi,3), predicted_edges (Qi,2),
        pred_edges_vertices (Qi,2,3), wf_vertices (Vi,3), wf_edges (Ei,2),
        wf_edges_vertices (Ei,2,3).  Optional `edge_distance` (length-B
        sequence of (Qi, Ei) matrices) supplies PRECOMPUTED pred-vs-GT
        segment Hausdorff distances — the batched on-device pass
        (eval/distributed.py) feeds these; None entries fall back to the
        host computation.
        """
        batch_size = len(batch["predicted_vertices"])
        precomputed = batch.get("edge_distance")
        for b in range(batch_size):
            self.accumulate_sample(
                np.asarray(batch["predicted_vertices"][b]).reshape(-1, 3),
                np.asarray(batch["predicted_edges"][b]).reshape(-1, 2),
                np.asarray(batch["pred_edges_vertices"][b]).reshape(-1, 2, 3),
                np.asarray(batch["wf_vertices"][b]).reshape(-1, 3),
                np.asarray(batch["wf_edges"][b]).reshape(-1, 2),
                np.asarray(batch["wf_edges_vertices"][b]).reshape(-1, 2, 3),
                edge_distance=(None if precomputed is None
                               else precomputed[b]),
            )

    def accumulate_sample(self, predicted_corners, predicted_edges,
                          pred_edges_vertices, label_corners, label_edges,
                          label_edges_vertices, edge_distance=None) -> None:
        """Accumulate ONE sample's counters (and its num_samples tick) —
        the single entry point both compute_metrics and the fused eval
        pipeline use, so the bookkeeping cannot desynchronize."""
        self._accumulate_sample(
            predicted_corners, predicted_edges, pred_edges_vertices,
            label_corners, label_edges, label_edges_vertices,
            edge_distance=edge_distance)
        self.num_samples += 1

    def merge_counters(self, others) -> "APCalculator":
        """Fold other calculators' raw counters into this one (pod-scale
        eval: each shard accumulates independently, then counters merge —
        every `summarize` ratio is a function of the summed counters)."""
        for o in others:
            for k in _COUNTER_KEYS:
                self.ap_dict[k] += o.ap_dict[k]
            self.num_samples += o.num_samples
        return self

    def _accumulate_sample(self, predicted_corners, predicted_edges,
                           pred_edges_vertices, label_corners, label_edges,
                           label_edges_vertices, edge_distance=None) -> None:
        thresh = self.distance_thresh
        if len(predicted_edges) != 0:
            # 1. Edge matching on sampled Hausdorff distances.
            if edge_distance is None:
                edge_distance = hausdorff_distance_line(
                    pred_edges_vertices, label_edges_vertices)
            else:
                edge_distance = np.asarray(edge_distance, np.float64)
                assert edge_distance.shape == (len(predicted_edges),
                                               len(label_edges))
            pi, li = linear_sum_assignment(edge_distance)
            edge_mask = edge_distance[pi, li] <= thresh
            pr_corners = pred_edges_vertices[pi[edge_mask]]
            gt_corners = label_edges_vertices[li[edge_mask]]
            pr_unique = np.unique(pr_corners.reshape(-1, 3), axis=0)
            gt_unique = np.unique(gt_corners.reshape(-1, 3), axis=0)

            # 2. Corners not explained by positive edges get their own
            #    Hungarian chance.
            un_pr = setdiff_rows(predicted_corners, pr_unique)
            un_gt = setdiff_rows(label_corners, gt_unique)
            dm = _cdist(un_pr, un_gt)
            upi, uli = linear_sum_assignment(dm)
            un_mask = dm[upi, uli] <= thresh
            distances = float(np.sum(dm[upi[un_mask], uli[un_mask]]))

            tp_corners = len(pr_unique) + int(np.sum(un_mask))
            tp_fp_corners = len(predicted_corners)
            tp_fn_corners = len(label_corners)
            tp_edges = int(np.sum(edge_mask))
            tp_fp_edges = len(predicted_edges)
            tp_fn_edges = len(label_edges)

            # 3. Positive-corner offsets: nearest GT corner per unique
            #    positive predicted corner.
            if len(pr_unique) > 0:
                distances += float(np.sum(
                    np.min(_cdist(pr_unique, gt_unique), axis=1)))

            # 4. WED on the reference's GT-derived submission: the
            #    submission wireframe is built from the GT edge vertex set
            #    (ap_calculator.py:236-242; its snapping of matched
            #    predicted edges there is dead — the snapped array is
            #    never consumed — so it is not reproduced here).
            submission_corners = np.unique(
                label_edges_vertices.reshape(-1, 3), axis=0)
            submission_edges = compute_edge_indices(
                label_edges_vertices, submission_corners)
            wed = graph_edit_distance(
                submission_corners, submission_edges.copy(),
                label_corners.copy(), label_edges.copy(), distances)
        else:
            # Corners-only fallback: the sample counts as an empty model.
            dm = _cdist(predicted_corners, label_corners)
            pi, li = linear_sum_assignment(dm)
            mask = dm[pi, li] <= thresh
            distances = float(np.sum(dm[pi[mask], li[mask]]))
            tp_corners = int(np.sum(mask))
            tp_fp_corners = len(predicted_corners)
            tp_fn_corners = len(label_corners)
            tp_edges = 0
            tp_fp_edges = 0
            tp_fn_edges = len(label_edges)
            wed = 1

        d = self.ap_dict
        d["tp_corners"] += tp_corners
        d["tp_fp_corners"] += tp_fp_corners
        d["tp_fn_corners"] += tp_fn_corners
        d["distance"] += distances
        d["wed"] += wed
        d["tp_edges"] += tp_edges
        d["tp_fp_edges"] += tp_fp_edges
        d["tp_fn_edges"] += tp_fn_edges

    def summarize(self) -> Dict[str, float]:
        """Finalize ratios (does not print)."""
        d = self.ap_dict

        def ratio(num, den):
            return num / den if den > 0 else 0.0

        d["average_corner_offset"] = ratio(d["distance"], d["tp_corners"])
        d["average_wed"] = ratio(d["wed"], self.num_samples)
        d["corners_precision"] = ratio(d["tp_corners"], d["tp_fp_corners"])
        d["corners_recall"] = ratio(d["tp_corners"], d["tp_fn_corners"])
        pr_sum = d["corners_precision"] + d["corners_recall"]
        d["corners_f1"] = ratio(
            2 * d["corners_precision"] * d["corners_recall"], pr_sum)
        d["edges_precision"] = ratio(d["tp_edges"], d["tp_fp_edges"])
        d["edges_recall"] = ratio(d["tp_edges"], d["tp_fn_edges"])
        er_sum = d["edges_precision"] + d["edges_recall"]
        d["edges_f1"] = ratio(
            2 * d["edges_precision"] * d["edges_recall"], er_sum)
        return dict(d)

    def output_accuracy(self) -> Dict[str, float]:
        """Finalize and print (same lines as ap_calculator.py:294-302)."""
        d = self.summarize()
        print("Wireframe Edit distance", d["average_wed"])
        print("Average Corner offset", d["average_corner_offset"])
        print("Corners Precision: ", d["corners_precision"])
        print("Corners Recall: ", d["corners_recall"])
        print("Corners F1:", d["corners_f1"])
        print("Edges Precision: ", d["edges_precision"])
        print("Edges Recall: ", d["edges_recall"])
        print("Edges F1: ", d["edges_f1"])
        return d
