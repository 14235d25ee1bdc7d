"""Host-side decode of one sample's raw model outputs into a wireframe.

Port of `decode_predictions` (wireframe_tpu/eval/evaluator.py:39-62), and
`decode_wireframe`, the emitted wireframe of `test.py` / `serve.py`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from wireframe_tpu_torch.data.building3d import edge_endpoint_array
from wireframe_tpu_torch.ops.pairs import pairs_from_mask, pairs_from_slot_mask


def decode_predictions(pred_vertices: np.ndarray, edge_probs: np.ndarray,
                       dynamic_count: int, max_vertices: int,
                       thresh: float = 0.5,
                       live_mask: Optional[np.ndarray] = None
                       ) -> Dict[str, np.ndarray]:
    """Decode one sample's raw arrays into wireframe structures.

    live_mask (V,) bool selects live slots directly (the "existence"
    slot-mask mode, where live slots are scattered); without it the
    reference prefix convention applies (first dynamic_count slots).
    """
    if live_mask is not None:
        pd_edges = pairs_from_slot_mask(
            edge_probs, live_mask, max_vertices, thresh)
    else:
        pd_edges = pairs_from_mask(
            edge_probs, dynamic_count, max_vertices, thresh)
    pd_edges_vertices = edge_endpoint_array(
        np.asarray(pred_vertices, np.float64), pd_edges)
    return {
        "vertices": np.asarray(pred_vertices),
        "edges": pd_edges,
        "edges_vertices": pd_edges_vertices,
    }


def decode_wireframe(cfg, verts: np.ndarray, probs: np.ndarray, count: int,
                     existence: np.ndarray):
    """The wireframe a sample's raw predictions emit, in the model's
    normalized frame: (vertices (C, 3), edges (K, 2) into them).  In the
    existence slot-mask mode the live slots, compacted, with the edges
    re-indexed into them; in the prefix mode the first `count` slots and
    the edges among them."""
    v = cfg.model.max_vertices
    if cfg.model.slot_mask_mode == "existence":
        live = existence > cfg.eval.vertex_existence_thresh
        dec = decode_predictions(verts, probs, count, v,
                                 cfg.eval.edge_confidence_thresh,
                                 live_mask=live)
        live_idx = np.nonzero(live)[0]
        remap = -np.ones(v, dtype=np.int64)
        remap[live_idx] = np.arange(len(live_idx))
        return dec["vertices"][live_idx], remap[dec["edges"]]
    dec = decode_predictions(verts, probs, count, v,
                             cfg.eval.edge_confidence_thresh)
    return (dec["vertices"][:count],
            dec["edges"][(dec["edges"] < count).all(axis=1)])
