"""The benchmark's frozen corpus generator and host-side batch makers.

A frozen copy of the port's synthetic Building3D generator
(`wireframe_tpu_torch/tools/gen_demo_data.py`, `--mix real`: the same
roof families, block counts and draws), so that a later change to the
program cannot change the benchmark's traffic.  One addition:
`make_building(rng, n_points=...)` sets the cloud's point count exactly
(the serving traffic draws it from the real corpus's range), after the
same draws as the original.

The batch makers copy the loader's host transforms
(`data/building3d.py`: channel selection, centroid and max-radius
normalisation, sampling to `num_points`, the z-sort, the fixed-shape
collate with edge labels on the global pair axis).  Nothing here
imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

def _rect(w, d, h):
    """Footprint corners at height h, counter-clockwise."""
    return np.array([[0, 0, h], [w, 0, h], [w, d, h], [0, d, h]], float)


def _roof_flat(rng, w, d):
    h = rng.uniform(3, 9)
    verts = _rect(w, d, h)
    edges = [[0, 1], [1, 2], [2, 3], [3, 0]]
    tris = [[0, 1, 2], [0, 2, 3]]
    return verts, edges, tris


def _roof_shed(rng, w, d):
    h = rng.uniform(3, 8)
    h2 = h + rng.uniform(1, 3)
    verts = _rect(w, d, h)
    verts[2, 2] = h2
    verts[3, 2] = h2
    edges = [[0, 1], [1, 2], [2, 3], [3, 0]]
    tris = [[0, 1, 2], [0, 2, 3]]
    return verts, edges, tris


def _roof_gable(rng, w, d):
    h = rng.uniform(3, 8)
    ridge_h = h + rng.uniform(1, 4)
    verts = np.vstack([
        _rect(w, d, h),
        [[w / 2, 0, ridge_h], [w / 2, d, ridge_h]],     # ridge along y
    ])
    edges = [[0, 1], [1, 2], [2, 3], [3, 0],            # eave loop
             [0, 4], [1, 4], [2, 5], [3, 5],            # rafters
             [4, 5]]                                    # ridge
    tris = [[0, 1, 4], [1, 4, 5], [1, 2, 5],            # roof planes +
            [2, 3, 5], [3, 5, 4], [3, 0, 4]]            # gable-end walls
    return verts, edges, tris


def _roof_hip(rng, w, d):
    h = rng.uniform(3, 8)
    ridge_h = h + rng.uniform(1, 4)
    inset = rng.uniform(0.2, 0.4) * min(w, d)
    verts = np.vstack([
        _rect(w, d, h),
        [[w / 2, inset, ridge_h], [w / 2, d - inset, ridge_h]],
    ])
    edges = [[0, 1], [1, 2], [2, 3], [3, 0],
             [0, 4], [1, 4], [2, 5], [3, 5],
             [4, 5]]
    tris = [[0, 1, 4],                                  # front hip face
            [2, 3, 5],                                  # back hip face
            [1, 2, 5], [1, 5, 4],                       # right plane
            [3, 0, 4], [3, 4, 5]]                       # left plane
    return verts, edges, tris


def _roof_pyramid(rng, w, d):
    h = rng.uniform(3, 8)
    apex_h = h + rng.uniform(1.5, 5)
    verts = np.vstack([_rect(w, d, h), [[w / 2, d / 2, apex_h]]])
    edges = [[0, 1], [1, 2], [2, 3], [3, 0],
             [0, 4], [1, 4], [2, 4], [3, 4]]
    tris = [[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]]
    return verts, edges, tris


def _roof_tee_gable(rng, w, d):
    """Cross-gable: a perpendicular wing tees into the main roof plane.

    This is the one family whose topology is NOT block-local: the wing's
    ridge penetrates the main north roof plane at a junction vertex, and
    two VALLEY edges run from the wing's eave corners up to it — the
    ridge-junction/valley motif the real Tallinn compounds have and the
    round-4 pretrain study found missing from the synthetic distribution
    (QUALITY.md: "pretraining transfers geometry, not topology").
    """
    h = rng.uniform(3, 8)
    hr = h + rng.uniform(1.5, 4)            # main ridge height
    hrb = h + rng.uniform(0.8, 1.0) * (hr - h - 0.3)  # wing ridge < main
    wb = rng.uniform(0.25, 0.45) * w        # wing width
    xb = rng.uniform(0.1, 0.9) * (w - wb)   # wing attach offset
    db = rng.uniform(0.4, 1.0) * d          # wing length (extends +y)
    # Wing ridge (height hrb) meets the main north plane
    # z = hr - (y - d/2) * 2 (hr - h) / d at:
    ys = d / 2 + (hr - hrb) * (d / 2) / (hr - h)
    verts = np.array([
        [0, 0, h], [w, 0, h], [w, d, h], [0, d, h],      # main eaves
        [0, d / 2, hr], [w, d / 2, hr],                  # main ridge ends
        [xb, d, h], [xb + wb, d, h],                     # valley feet
        [xb, d + db, h], [xb + wb, d + db, h],           # wing eaves
        [xb + wb / 2, d + db, hrb],                      # wing gable ridge
        [xb + wb / 2, ys, hrb],                          # junction on plane
    ])
    edges = [[0, 1], [1, 2], [3, 0],                     # main eave loop
             [3, 6], [7, 2],                             # north eave splits
             [0, 4], [3, 4], [1, 5], [2, 5],             # main gable rafters
             [4, 5],                                     # main ridge
             [6, 8], [7, 9], [8, 9],                     # wing eaves
             [8, 10], [9, 10],                           # wing gable rafters
             [10, 11],                                   # wing ridge
             [6, 11], [7, 11]]                           # VALLEYS
    tris = [[0, 1, 5], [0, 5, 4],                        # main south plane
            [11, 3, 6], [11, 7, 2], [11, 2, 5],          # main north plane,
            [11, 5, 4], [11, 4, 3],                      # fan around junction
            [6, 8, 10], [6, 10, 11],                     # wing west plane
            [7, 9, 10], [7, 10, 11],                     # wing east plane
            [8, 9, 10],                                  # wing gable-end wall
            [0, 4, 3], [1, 2, 5]]                        # main gable walls
    return verts, edges, tris


def _roof_m(rng, w, d):
    """M-roof: two parallel gables over one footprint, center VALLEY."""
    h = rng.uniform(3, 8)
    hr = h + rng.uniform(1.5, 4)
    hv = h + rng.uniform(0.1, 0.5) * (hr - h)   # valley above the eave
    x1, xv, x2 = w / 4, w / 2, 3 * w / 4
    verts = np.array([
        [0, 0, h], [w, 0, h], [w, d, h], [0, d, h],      # eave corners
        [x1, 0, hr], [x1, d, hr],                        # ridge 1 ends
        [x2, 0, hr], [x2, d, hr],                        # ridge 2 ends
        [xv, 0, hv], [xv, d, hv],                        # valley ends
    ])
    edges = [[0, 1], [1, 2], [2, 3], [3, 0],             # eave loop
             [0, 4], [3, 5], [1, 6], [2, 7],             # outer rafters
             [4, 8], [5, 9], [6, 8], [7, 9],             # inner rafters
             [4, 5], [6, 7],                             # ridges
             [8, 9]]                                     # VALLEY
    tris = [[0, 4, 5], [0, 5, 3],                        # west plane
            [4, 8, 9], [4, 9, 5],                        # inner-west plane
            [8, 6, 7], [8, 7, 9],                        # inner-east plane
            [6, 1, 2], [6, 2, 7],                        # east plane
            # End walls fan from the VALLEY vertex: the M profile
            # 0-4-8-6-1 is reflex at the valley, so a fan from an eave
            # corner is invalid — its middle triangle inverts and covers
            # the wedge ABOVE the valley (off-surface points in the sky).
            [8, 0, 4], [8, 1, 0], [8, 6, 1],             # front end wall
            [9, 3, 5], [9, 2, 3], [9, 7, 2]]             # back end wall
    return verts, edges, tris


def _triangulate(poly) -> list:
    """Ear-clip a simple 2D polygon into triangles (vertex indices).

    The rectilinear L/T/U/Z outlines are non-convex, so a fan from one
    corner is invalid in general (the exact failure mode fixed for the
    M-roof end walls in 8b6b738); ear clipping handles any simple
    polygon.  Orientation is normalized to CCW internally; returned
    indices refer to the input order.
    """
    poly = np.asarray(poly, float)
    idx = list(range(len(poly)))
    x, y = poly[:, 0], poly[:, 1]
    if (x @ np.roll(y, -1) - y @ np.roll(x, -1)) < 0:   # CW -> reverse
        idx.reverse()

    def cross(o, a, b):
        return ((a[0] - o[0]) * (b[1] - o[1]) -
                (a[1] - o[1]) * (b[0] - o[0]))

    def covers(p, a, b, c):                 # inside or on the border
        return (cross(a, b, p) >= -1e-9 and cross(b, c, p) >= -1e-9
                and cross(c, a, p) >= -1e-9)

    tris = []
    while len(idx) > 3:
        for k in range(len(idx)):
            i0 = idx[k - 1]
            i1 = idx[k]
            i2 = idx[(k + 1) % len(idx)]
            a, b, c = poly[i0], poly[i1], poly[i2]
            if cross(a, b, c) <= 1e-9:      # reflex or collinear corner
                continue
            if any(covers(poly[j], a, b, c) for j in idx
                   if j not in (i0, i1, i2)):
                continue
            tris.append([i0, i1, i2])
            idx.pop(k)
            break
        else:
            raise ValueError("ear clipping failed: not a simple polygon")
    tris.append(list(idx))
    return tris


def _roof_poly(rng, w, d):
    """One planar roof over a rectilinear L/T/U/Z footprint.

    The dominant motif of the real corpus that every rectangle family
    misses: a long eave OUTLINE LOOP whose vertices are all degree 2
    (the real 43 are 70% degree-2; the rectangle-gable families are
    ~70-80% degree-3 rafter junctions — tools/corpus_stats.py).  One
    slightly-graded plane covers the whole footprint, so E/V = 1.0.
    """
    h = rng.uniform(3, 9)
    shape = int(rng.integers(4))
    if shape == 0:      # L: corner notch
        x1, y1 = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * d
        poly = [(0, 0), (w, 0), (w, y1), (x1, y1), (x1, d), (0, d)]
    elif shape == 1:    # T: bump on the top edge
        d1 = rng.uniform(0.4, 0.7) * d
        x1 = rng.uniform(0.15, 0.45) * w
        x2 = rng.uniform(x1 + 0.2 * w, 0.9 * w)
        poly = [(0, 0), (w, 0), (w, d1), (x2, d1), (x2, d), (x1, d),
                (x1, d1), (0, d1)]
    elif shape == 2:    # U: notch into the top edge
        y1 = rng.uniform(0.35, 0.65) * d
        x1, x2 = rng.uniform(0.2, 0.4) * w, rng.uniform(0.6, 0.8) * w
        poly = [(0, 0), (w, 0), (w, d), (x2, d), (x2, y1), (x1, y1),
                (x1, d), (0, d)]
    else:               # Z: two offset strips
        d1 = rng.uniform(0.35, 0.65) * d
        x1, x2 = rng.uniform(0.1, 0.35) * w, rng.uniform(0.55, 0.9) * w
        poly = [(0, 0), (x2, 0), (x2, d1), (w, d1), (w, d), (x1, d),
                (x1, d1), (0, d1)]
    poly = np.asarray(poly, float)
    gx, gy = rng.uniform(-0.12, 0.12, 2)    # gentle planar grade
    z = h + gx * poly[:, 0] + gy * poly[:, 1]
    z += h - z.min()                        # keep the eave above ground
    verts = np.column_stack([poly, z])
    n = len(poly)
    edges = [[i, (i + 1) % n] for i in range(n)]
    return verts, edges, _triangulate(poly)

_REAL_MIX = ((_roof_poly, 0.68), (_roof_flat, 0.03), (_roof_shed, 0.03),
             (_roof_gable, 0.07), (_roof_hip, 0.05), (_roof_pyramid, 0.03),
             (_roof_tee_gable, 0.05), (_roof_m, 0.06))
_REAL_BLOCK_P = (0.40, 0.20, 0.22, 0.18)    # 1-4 blocks, mean 2.18
_REAL_FAMS = tuple(f for f, _ in _REAL_MIX)
_REAL_W = np.asarray([w for _, w in _REAL_MIX])
_MAX_VERTS = 38                             # real corpus spans 4-38


def _sample_faces(rng, verts, tris, n_pts):
    """Uniform points on the union of triangles, ~area-proportional."""
    corners = verts[np.asarray(tris)]                   # (T, 3, 3)
    areas = 0.5 * np.linalg.norm(
        np.cross(corners[:, 1] - corners[:, 0],
                 corners[:, 2] - corners[:, 0]), axis=-1)
    weights = areas / max(areas.sum(), 1e-9)
    counts = rng.multinomial(n_pts, weights)
    pts = []
    for (a, b, c), k in zip(corners, counts):
        if k == 0:
            continue
        u = rng.random((k, 1))
        v = rng.random((k, 1))
        flip = (u + v) > 1
        u = np.where(flip, 1 - u, u)
        v = np.where(flip, 1 - v, v)
        pts.append(a + u * (b - a) + v * (c - a))
    return np.vstack(pts)


def make_building(rng: np.random.Generator,
                  n_points: Optional[int] = None):
    """1-4 adjacent roof blocks (the `real` mixture) -> (cloud (N, 8)
    float64 in a UTM-like frame, verts (V, 3), edges (E, 2)).

    n_points: the cloud's exact point count; None keeps the generator's
    own draw of 2000-6000."""
    n_blocks = 1 + int(rng.choice(4, p=_REAL_BLOCK_P))
    all_verts, all_edges, all_pts, kept_tris = [], [], [], []
    n_pts_total = int(rng.integers(2000, 6000))
    if n_points is not None:
        n_pts_total = int(n_points)
    cursor_x = 0.0
    total_v = 0
    for bi in range(n_blocks):
        w, d = rng.uniform(6, 18), rng.uniform(6, 18)
        fam = _REAL_FAMS[int(rng.choice(len(_REAL_FAMS), p=_REAL_W))]
        verts, edges, tris = fam(rng, w, d)
        if total_v + len(verts) > _MAX_VERTS:
            break                            # vertex budget (real spans 4-38)
        total_v += len(verts)
        offs = np.array([cursor_x, rng.uniform(-0.3, 0.3) * d if bi else 0.0,
                         0.0])
        verts = verts + offs
        base = sum(len(v) for v in all_verts)
        all_verts.append(verts)
        all_edges.append(np.asarray(edges) + base)
        kept_tris.append(tris)
        cursor_x += w
    per_block = max(n_pts_total // len(all_verts), 200)
    for verts, tris in zip(all_verts, kept_tris):
        all_pts.append(_sample_faces(rng, verts, tris, per_block))
    verts = np.vstack(all_verts)
    edges = np.vstack(all_edges)
    pc = np.vstack(all_pts)
    pc += rng.normal(scale=rng.uniform(0.03, 0.08), size=pc.shape)

    theta = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pc = pc @ rot.T
    verts = verts @ rot.T

    offset = np.array([534000.0, 6588000.0, 0.0]) + rng.uniform(0, 900, 3)
    pc += offset
    verts = verts + offset

    n = len(pc)
    rgba = rng.uniform(0, 255, (n, 4))
    intensity = rng.uniform(46000, 48000, (n, 1))
    cloud = np.hstack([pc, rgba, intensity])
    if n_points is not None and n != n_points:
        # Integer division over the blocks leaves a few points short (or
        # the 200-point floor a few over): draw exactly n_points rows.
        cloud = cloud[rng.choice(n, n_points, replace=n < n_points)]
    return cloud, verts, edges


# ---------------------------------------------------------------------------
# Host transforms of the loader (data/building3d.py, io/xyz.py)
# ---------------------------------------------------------------------------

def select_features(raw: np.ndarray) -> np.ndarray:
    """XYZ, RGBA / 256 and intensity / 2^16 (use_color, use_intensity and
    scale_intensity, as both configurations run)."""
    pc = np.array(raw, np.float64, copy=True)
    pc[:, 3:7] /= 256.0
    pc[:, 7] /= 65536.0
    return pc


def normalize(pc: np.ndarray, verts: Optional[np.ndarray] = None):
    """Centroid and max-radius normalisation of the XYZ channels (and of
    `verts` alike): (pc, verts, centroid, max_distance)."""
    pc = pc.copy()
    centroid = np.mean(pc[:, 0:3], axis=0)
    pc[:, 0:3] -= centroid
    max_distance = max(float(np.max(np.linalg.norm(pc[:, 0:3], axis=1))),
                       1e-12)
    pc[:, 0:3] /= max_distance
    if verts is not None:
        verts = (verts - centroid) / max_distance
    return pc, verts, centroid, max_distance


def z_sort_rows(pc: np.ndarray) -> np.ndarray:
    """Stable ascending z-sort with all-zero padding rows kept last."""
    zkey = np.where(np.abs(pc.sum(-1)) > 1e-9, pc[:, 2], np.inf)
    return pc[np.argsort(zkey, kind="stable")]


def edge_labels(edges: np.ndarray, v: int) -> np.ndarray:
    """(V(V-1)/2,) labels on the lexicographic upper-triangular pair axis."""
    labels = np.zeros(v * (v - 1) // 2, np.float32)
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    lo, hi = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    keep = (lo >= 0) & (hi < v) & (lo != hi)
    lo, hi = lo[keep], hi[keep]
    labels[lo * v - (lo * (lo + 1)) // 2 + (hi - lo - 1)] = 1.0
    return labels


def train_sample(rng: np.random.Generator, num_points: int,
                 z_sort: bool) -> Dict[str, np.ndarray]:
    """One corpus-like training sample, as the loader hands it over with
    device augmentation on (no host augmentation)."""
    raw, verts, edges = make_building(rng)
    pc, verts, _, _ = normalize(select_features(raw), verts)
    pc = pc[rng.choice(pc.shape[0], num_points,
                       replace=pc.shape[0] < num_points)]
    if z_sort:
        pc = z_sort_rows(pc)
    return {"pc": pc.astype(np.float32), "verts": verts.astype(np.float32),
            "edges": np.asarray(edges, np.int64)}


def train_batch(rng: np.random.Generator, batch: int, num_points: int,
                max_vertices: int, z_sort: bool) -> Dict[str, np.ndarray]:
    """The train step's five arrays (`train.step.BATCH_KEYS`) for `batch`
    fresh samples."""
    v = max_vertices
    out = {"point_clouds": np.zeros((batch, num_points, 8), np.float32),
           "target_vertices": np.zeros((batch, v, 3), np.float32),
           "vertex_existence": np.zeros((batch, v), np.float32),
           "vertex_counts": np.zeros((batch,), np.int32),
           "edge_labels": np.zeros((batch, v * (v - 1) // 2), np.float32)}
    for i in range(batch):
        s = train_sample(rng, num_points, z_sort)
        c = min(len(s["verts"]), v)
        out["point_clouds"][i] = s["pc"]
        out["target_vertices"][i, :c] = s["verts"][:c]
        out["vertex_existence"][i, :c] = 1.0
        out["vertex_counts"][i] = c
        out["edge_labels"][i] = edge_labels(s["edges"], v)
    return out


def infer_batch(rng: np.random.Generator, batch: int, num_points: int,
                z_sort: bool) -> np.ndarray:
    """(batch, num_points, 8) float32 normalised, sampled clouds."""
    return np.stack([train_sample(rng, num_points, z_sort)["pc"]
                     for _ in range(batch)])


def log_uniform_sizes(count: int, lo: int, hi: int) -> List[int]:
    """`count` point counts at the mid-quantiles of a log-uniform law on
    [lo, hi]: the same set for every seed, so seeds change the clouds and
    their order, not the amount of work."""
    q = (np.arange(count) + 0.5) / count
    return [int(round(float(np.exp(np.log(lo) + q_ * (np.log(hi)
                                                     - np.log(lo))))))
            for q_ in q]
