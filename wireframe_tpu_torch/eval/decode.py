"""Host-side decode of one sample's raw model outputs into a wireframe.

Port of `decode_predictions` (wireframe_tpu/eval/evaluator.py:39-62) and
`edge_endpoint_array` (wireframe_tpu/data/building3d.py:47-57).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from wireframe_tpu_torch.ops.pairs import pairs_from_mask, pairs_from_slot_mask


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
