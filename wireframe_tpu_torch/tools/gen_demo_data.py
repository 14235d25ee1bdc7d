"""Generate a synthetic Building3D-format corpus.

The port's copy of `tools/gen_demo_data.py`: the same families, the same
draws in the same order and the same text formats, so for one `--seed`,
`--train`, `--test` and `--mix` both write the same bytes in every file.

The reference bundles 43 train / 8 test real LiDAR roofs; those data
files belong to the Building3D benchmark distribution and are not copied
here.  This tool synthesizes structurally similar samples in the exact
on-disk layout (`<root>/{train,test}/{xyz,wireframe}`), so every CLI and
test can run without the real corpus — and so a large pretraining corpus
can be produced on demand (QUALITY.md round-4 synthetic-pretrain study).

Building families (per block): flat, shed, gable, hip, pyramid roofs on
rectangular footprints; two CONNECTED-topology families — a cross-gable
whose wing ridge tees into the main roof plane (junction vertex + two
valley edges) and an M-roof (parallel gables, center valley); and a
POLYGONAL-OUTLINE family (L/T/U/Z rectilinear footprints under one
planar roof — a pure degree-2 eave loop).  A building is 1-4 adjacent
blocks with random sizes/heights plus a random whole-building
z-rotation, capped at 38 wireframe vertices (the real Tallinn corpus
spans 4-38).

Two mixtures (`--mix`): `real` (default) weights families and block
counts to match the measured topology statistics of the real 43-roof
corpus — ~70% degree-2 vertices, E/V ~1.15, ~2.2 wireframe components
per building (tools/corpus_stats.py; the round-4 rectangle-gable
corpora were inverted at 67-81% degree-3, half the size, E/V ~1.4) —
and `uniform` reproduces the round-4 corpora exactly (uniform over the
rectangle families, 1-3 blocks, same RNG stream).
Clouds get planar roof/gable-end surface points with Gaussian sensor
noise, UTM-magnitude coordinates, RGBA in [0,255] and raw ~46-48k
intensity — matching the measured statistics of the real corpus
(reference datasets/, SURVEY.md §2 corpus row).

Usage:
  python -m wireframe_tpu_torch.tools.gen_demo_data --out datasets \
      --train 12 --test 4
  python -m wireframe_tpu_torch.tools.gen_demo_data --out syn5k \
      --train 5000 --test 100
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from wireframe_tpu_torch.io.obj import save_wireframe


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


_FAMILIES = (_roof_flat, _roof_shed, _roof_gable, _roof_hip, _roof_pyramid,
             _roof_tee_gable, _roof_m)

# `real` mixture: family weights + 1-4 block counts tuned so the
# generated corpus matches the real 43-roof topology profile measured
# by tools/corpus_stats.py (deg-2 ~70%, E/V ~1.15, ~2.2 components,
# V p90 ~30).  Vertex-weighted accounting in the module docstring.
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


def make_building(rng: np.random.Generator, mix: str = "real"):
    """1-4 adjacent roof blocks -> (cloud (N,8), verts (V,3), edges (E,2)).

    `mix="real"` draws block counts and families from the
    topology-matched weights above, with a 38-vertex building budget;
    `mix="uniform"` reproduces the round-4 corpora exactly (1-3 blocks,
    uniform over the rectangle/connected families, identical RNG
    consumption order — do not reorder its draws).
    """
    if mix == "real":
        n_blocks = 1 + int(rng.choice(4, p=_REAL_BLOCK_P))
    elif mix == "uniform":
        n_blocks = rng.choice([1, 2, 3], p=[0.45, 0.4, 0.15])
    else:
        raise ValueError(f"unknown mix {mix!r}: expected 'real'/'uniform'")
    all_verts, all_edges, all_pts, kept_tris = [], [], [], []
    n_pts_total = int(rng.integers(2000, 6000))
    cursor_x = 0.0
    total_v = 0
    for bi in range(n_blocks):
        w, d = rng.uniform(6, 18), rng.uniform(6, 18)
        if mix == "real":
            fam = _REAL_FAMS[int(rng.choice(len(_REAL_FAMS), p=_REAL_W))]
        else:
            fam = _FAMILIES[rng.integers(len(_FAMILIES))]
        verts, edges, tris = fam(rng, w, d)
        if total_v + len(verts) > _MAX_VERTS:
            break                            # vertex budget (real spans 4-38)
        total_v += len(verts)
        # Adjacent placement along +x, with a random y offset so
        # footprints form L/T-ish compounds instead of a strip.
        offs = np.array([cursor_x, rng.uniform(-0.3, 0.3) * d if bi else 0.0,
                         0.0])
        verts = verts + offs
        base = sum(len(v) for v in all_verts)
        all_verts.append(verts)
        all_edges.append(np.asarray(edges) + base)
        if mix == "uniform":
            # Inline sampling with the PLANNED divisor: part of the
            # frozen uniform RNG stream (byte-compatible with the
            # round-4 corpora; the budget break can never fire at
            # 1-3 blocks x <=12 verts).
            all_pts.append(_sample_faces(rng, verts, tris,
                                         max(n_pts_total // n_blocks, 200)))
        else:
            kept_tris.append(tris)
        cursor_x += w
    if mix == "real":
        # Sample after the budget is settled so the cloud splits the
        # full drawn total over the KEPT blocks — a budget break must
        # not thin the cloud of large buildings.
        per_block = max(n_pts_total // len(all_verts), 200)
        for verts, tris in zip(all_verts, kept_tris):
            all_pts.append(_sample_faces(rng, verts, tris, per_block))
    verts = np.vstack(all_verts)
    edges = np.vstack(all_edges)
    pc = np.vstack(all_pts)
    pc += rng.normal(scale=rng.uniform(0.03, 0.08), size=pc.shape)

    # Random whole-building orientation (the real corpus has arbitrary
    # street-grid headings; training augment only covers ±5°).
    theta = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pc = pc @ rot.T
    verts = verts @ rot.T

    # Place in a UTM-like frame (Tallinn-ish magnitudes, like the corpus).
    offset = np.array([534000.0, 6588000.0, 0.0]) + rng.uniform(0, 900, 3)
    pc += offset
    verts = verts + offset

    # 8 feature channels: XYZ, RGBA in [0,255], raw intensity ~46-48k.
    n = len(pc)
    rgba = rng.uniform(0, 255, (n, 4))
    intensity = rng.uniform(46000, 48000, (n, 1))
    cloud = np.hstack([pc, rgba, intensity])
    return cloud, verts, edges


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="datasets")
    p.add_argument("--train", type=int, default=12)
    p.add_argument("--test", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mix", choices=("real", "uniform"), default="real",
                   help="family/block mixture: 'real' matches the real "
                        "corpus topology profile; 'uniform' reproduces "
                        "the round-4 corpora")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    scan = 10000
    for split, count in (("train", args.train), ("test", args.test)):
        xyz_dir = os.path.join(args.out, split, "xyz")
        wf_dir = os.path.join(args.out, split, "wireframe")
        os.makedirs(xyz_dir, exist_ok=True)
        os.makedirs(wf_dir, exist_ok=True)
        for _ in range(count):
            scan += 1
            cloud, verts, edges = make_building(rng, mix=args.mix)
            np.savetxt(os.path.join(xyz_dir, f"{scan}.xyz"), cloud,
                       fmt="%.6f")
            save_wireframe(verts, edges,
                           os.path.join(wf_dir, f"{scan}.obj"))
    print(f"✓ synthetic corpus: {args.train} train / {args.test} test "
          f"under {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
