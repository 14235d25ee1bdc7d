"""Wireframe edit distance (WED) and edge-indexing helpers.

The port's copy of `wireframe_tpu/metrics/wed.py` (numpy only).

Semantics match eval/ap_calculator.py:39-105 (graph_edit_distance,
computer_edges, remove_corners), re-written as documented, vectorized
numpy.  The WED recipe: snap predicted vertices to their nearest GT
vertex (accumulating snap distances into the vertex term), merge
duplicates, re-index predicted edges; every predicted edge that does not
exist in the GT edge set adds its length to the edge term, as does every
GT edge never produced; normalize by total GT edge length.
"""

from __future__ import annotations

import numpy as np


def setdiff_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows of `a` not present in `b` — SORTED UNIQUE rows, matching the
    structured-dtype np.setdiff1d behavior of ap_calculator.py:101-105."""
    a = np.asarray(a).reshape(-1, a.shape[-1] if a.ndim > 1 else 3)
    b = np.asarray(b).reshape(-1, a.shape[1])
    if len(a) == 0:
        return a.copy()
    ua = np.unique(a, axis=0)
    if len(b) == 0:
        return ua
    # membership test via void view
    av = np.ascontiguousarray(ua).view([("", ua.dtype)] * ua.shape[1]).ravel()
    bv = np.ascontiguousarray(np.unique(b, axis=0)).view(
        [("", b.dtype)] * b.shape[1]).ravel()
    keep = ~np.isin(av, bv)
    return ua[keep]


def _rows_view(a: np.ndarray) -> np.ndarray:
    """1-D void view for whole-row equality / membership tests.

    Float rows are canonicalized (+0.0 == -0.0 under float equality but
    their bytes differ; `x + 0.0` maps -0.0 to +0.0)."""
    a = np.ascontiguousarray(a)
    if np.issubdtype(a.dtype, np.floating):
        a = np.ascontiguousarray(a + 0.0)
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


def _first_row_index(queries: np.ndarray, table: np.ndarray) -> np.ndarray:
    """For each query row, the FIRST index of an equal row in `table`
    (-1 when absent).  Vectorized replacement for the reference's
    per-row `np.where((table == q).all(1))[0][0]` scans
    (eval/ap_calculator.py:52-57, 84-98)."""
    queries = np.asarray(queries)
    table = np.asarray(table)
    if len(queries) == 0:
        return np.empty(0, np.int64)
    if len(table) == 0:
        return np.full(len(queries), -1, np.int64)
    # Void-view comparison needs one common dtype on both sides.
    common = np.result_type(queries.dtype, table.dtype)
    queries = queries.astype(common, copy=False)
    table = table.astype(common, copy=False)
    tv = _rows_view(table)
    qv = _rows_view(queries)
    order = np.argsort(tv, kind="stable")
    sv = tv[order]
    # Left-side searchsorted lands on the FIRST element of an equal-run;
    # stable sort keeps original order within equal keys, so order[pos]
    # is the smallest original index — matching the reference's hits[0].
    pos = np.searchsorted(sv, qv)
    safe = np.minimum(pos, len(table) - 1)
    hit = sv[safe] == qv
    return np.where(hit, order[safe], -1).astype(np.int64)


def compute_edge_indices(edges_vertices: np.ndarray,
                         vertices: np.ndarray) -> np.ndarray:
    """Map (n, 2, 3) edge endpoint coords to sorted (n, 2) vertex indices.

    Endpoint coords absent from `vertices` map to -1
    (eval/ap_calculator.py:84-98).  One sorted-membership pass instead of
    the reference's per-edge/per-side full scans (r2 VERDICT weak #5: the
    host loops dominate eval at corpus scale).
    """
    ev = np.asarray(edges_vertices, dtype=np.float64)
    vv = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    n = len(ev)
    if n == 0:
        return np.empty((0, 2), np.int64)
    flat = ev.reshape(n * 2, 3)
    out = _first_row_index(flat, vv).reshape(n, 2)
    return np.sort(out, axis=-1)


def graph_edit_distance(pd_vertices: np.ndarray, pd_edges: np.ndarray,
                        gt_vertices: np.ndarray, gt_edges: np.ndarray,
                        wed_v: float) -> float:
    """Normalized wireframe edit distance (ap_calculator.py:39-81).

    Args:
      pd_vertices: (P, 3) predicted corners (will be snapped; copied here).
      pd_edges: (Q, 2) predicted edge index pairs into pd_vertices.
      gt_vertices / gt_edges: ground truth.
      wed_v: pre-accumulated corner-offset distance (the caller's positive
        corner offsets seed the vertex term).
    """
    pd_vertices = np.array(pd_vertices, copy=True)
    gt_edges_left = np.array(gt_edges, copy=True)
    wed_e = 0.0

    if len(pd_vertices) > 0:
        # Snap every predicted vertex to its nearest GT vertex.
        diff = pd_vertices[:, None, :] - gt_vertices[None, :, :]
        dist = np.sqrt(np.sum(diff * diff, axis=-1))
        wed_v += float(np.sum(np.min(dist, axis=1)))
        nearest = np.argmin(dist, axis=1)
        pd_vertices = gt_vertices[nearest].copy()

        # Merge duplicates and re-index the predicted edges.
        uniq, inverse = np.unique(pd_vertices, axis=0, return_inverse=True)
        renew = inverse[np.asarray(pd_edges, dtype=np.int64)].reshape(-1, 2)
        renew = np.unique(renew, axis=0)

        if len(renew):
            # GT index of each snapped endpoint (every snapped vertex IS a
            # GT row, so lookups always hit); one sorted-membership pass
            # replaces the reference's per-edge scans
            # (ap_calculator.py:52-57).
            uniq_to_gt = _first_row_index(uniq, gt_vertices)
            pairs = np.sort(uniq_to_gt[renew], axis=1)          # (R, 2)
            in_gt = _first_row_index(pairs, np.asarray(gt_edges)
                                     .reshape(-1, 2)) >= 0
            # Unmatched predicted edges cost their length...
            seg = uniq[renew[~in_gt]]
            wed_e += float(np.sum(np.linalg.norm(
                seg[:, 0] - seg[:, 1], axis=-1))) if len(seg) else 0.0
            # ...and every copy of a matched pair leaves the GT-leftover
            # set (the reference removes all equal rows per match; the
            # exists-check is against the ORIGINAL gt_edges, so duplicate
            # renew pairs are no-ops — plain row set-difference).
            if in_gt.any():
                gone = _first_row_index(
                    np.asarray(gt_edges_left).reshape(-1, 2),
                    pairs[in_gt]) >= 0
                gt_edges_left = gt_edges_left[~gone]
    else:
        wed_v = 0.0

    # Every GT edge never matched costs its length.
    if len(gt_edges_left):
        wed_e += float(np.sum(np.linalg.norm(
            gt_vertices[gt_edges_left[:, 0]]
            - gt_vertices[gt_edges_left[:, 1]], axis=-1)))

    gt_edges = np.asarray(gt_edges).reshape(-1, 2)
    total = float(np.sum(np.linalg.norm(
        gt_vertices[gt_edges[:, 0]] - gt_vertices[gt_edges[:, 1]], axis=-1)))
    return (wed_e + wed_v) / total
