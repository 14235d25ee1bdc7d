"""Wavefront-`.obj` wireframe IO.

Semantics match the reference loader/saver (datasets/building3d.py:18-47):
`v x y z` lines are float64 vertices; `l a b` lines are 1-based edge index
pairs which are converted to 0-based, sorted per edge, and de-duplicated.
The reference's `save_wireframe` is dead code there; here it is a first-class
output path (used by `test.py` / inference egress).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_wireframe(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a wireframe .obj.

    Returns:
      vertices: (V, 3) float64
      edges:    (E, 2) int — 0-based, each row sorted ascending, unique rows.
                Row order is insertion order of first occurrence (set-free,
                deterministic — unlike the reference's Python-set ordering).
    """
    vertices = []
    edges = []
    seen = set()
    with open(path) as f:
        for raw in f:
            parts = raw.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "l":
                a, b = int(parts[1]) - 1, int(parts[2]) - 1
                key = (a, b) if a <= b else (b, a)
                if key not in seen:
                    seen.add(key)
                    edges.append(key)
    verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    edge_arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return verts, edge_arr


def save_wireframe(vertices: np.ndarray, edges: np.ndarray, path: str) -> None:
    """Emit a wireframe .obj: `v` lines then 1-based `l` lines."""
    vertices = np.asarray(vertices)
    edges = np.asarray(edges)
    with open(path, "w") as f:
        for v in vertices:
            f.write("v " + " ".join(str(x) for x in v) + "\n")
        for e in edges:
            f.write(f"l {int(e[0]) + 1} {int(e[1]) + 1}\n")
