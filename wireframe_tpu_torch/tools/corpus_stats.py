"""Wireframe-topology statistics for a Building3D-format corpus.

The port's copy of the repository's `tools/corpus_stats.py`: the same
statistics, rows and JSON, read through the port's `io/obj.py`.

Quantifies the distributional match between a synthetic pretraining
corpus and the real one — the round-4 pretrain study showed synthetic
pretraining transfers geometry (WED/ACO) but not edge topology (E-F1),
and this probe measures exactly what differs.  Measured on the real 43
Tallinn buildings (reference datasets/train, loaded by the same
io/obj.py rules as the reference's `datasets/building3d.py:192-197`
layout) vs the two round-4 synthetic corpora:

            V p10/50/90   E/V   deg 1/2/3/4+ %   1-comp%  comps mean
  real-43      8/18/31    1.15    0/70/27/2       39.5%     2.28
  syn-old      4/ 9/14    1.34    0/29/67/4       44.0%     1.72
  syn-new      4/10/20    1.39    0/17/81/2       48.2%     1.67

i.e. the real corpus is dominated by degree-2 outline vertices (long
polygonal eave loops), is ~2x larger, sparser in edges per vertex, and
is usually MULTI-component (compound parts not wired together) — while
the rectangle-footprint gable/hip families produce the opposite
profile.  Usage:

  python -m wireframe_tpu_torch.tools.corpus_stats --root CORPUS \
      [--root OTHER ...] [--split train] [--sample 500] [--json out.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from wireframe_tpu_torch.io.obj import load_wireframe


def _n_components(n_verts: int, edges: np.ndarray) -> int:
    parent = list(range(n_verts))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[ra] = rb
    return len({find(v) for v in range(n_verts)})


def corpus_stats(root: str, split: str = "train",
                 sample: int | None = None) -> dict:
    """Topology statistics over `<root>/<split>/wireframe/*.obj`."""
    files = sorted(glob.glob(os.path.join(root, split, "wireframe", "*.obj")))
    if not files:
        raise FileNotFoundError(f"no wireframes under {root}/{split}")
    n_total = len(files)
    if sample and sample < len(files):
        # Evenly spaced deterministic subsample (no RNG: reproducible).
        idx = np.linspace(0, len(files) - 1, sample).astype(int)
        files = [files[i] for i in idx]

    degs, vcounts, ev_ratios, comps = [], [], [], []
    for f in files:
        verts, edges = load_wireframe(f)
        v = len(verts)
        vcounts.append(v)
        ev_ratios.append(len(edges) / max(v, 1))
        d = np.zeros(v, dtype=int)
        np.add.at(d, edges[:, 0], 1)
        np.add.at(d, edges[:, 1], 1)
        degs.extend(d.tolist())
        comps.append(_n_components(v, edges))

    degs = np.asarray(degs)
    vcounts = np.asarray(vcounts)
    comps = np.asarray(comps)
    return {
        "n_corpus": n_total,
        "n_buildings": len(files),
        "v_p10": float(np.percentile(vcounts, 10)),
        "v_p50": float(np.percentile(vcounts, 50)),
        "v_p90": float(np.percentile(vcounts, 90)),
        "v_mean": float(vcounts.mean()),
        "edges_per_vertex": float(np.mean(ev_ratios)),
        # Degree 0 = orphan vertices ('v' lines no 'l' references) —
        # reported explicitly so a corpus with orphans can't silently
        # deflate the other buckets (they also count as components).
        "deg_pct": {str(k): float(100 * (degs == k).mean())
                    for k in (0, 1, 2, 3)} |
                   {"4+": float(100 * (degs >= 4).mean())},
        "deg_mean": float(degs.mean()),
        "single_component_pct": float(100 * (comps == 1).mean()),
        "components_mean": float(comps.mean()),
    }


def format_row(label: str, s: dict) -> str:
    d = s["deg_pct"]
    n = (f"{s['n_buildings']}/{s['n_corpus']}"
         if s["n_buildings"] != s["n_corpus"] else f"{s['n_corpus']}")
    return (f"{label:10s} n={n:>9s}  "
            f"V p10/50/90 {s['v_p10']:.0f}/{s['v_p50']:.0f}/{s['v_p90']:.0f}  "
            f"E/V {s['edges_per_vertex']:.2f}  "
            f"deg 0/1/2/3/4+ {d['0']:.0f}/{d['1']:.0f}/{d['2']:.0f}/"
            f"{d['3']:.0f}/{d['4+']:.0f}%  "
            f"1-comp {s['single_component_pct']:.0f}%  "
            f"comps {s['components_mean']:.2f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, action="append",
                   help="corpus root (repeatable for side-by-side rows)")
    p.add_argument("--split", default="train")
    p.add_argument("--sample", type=int, default=500,
                   help="evenly-spaced subsample cap per corpus (0 = all)")
    p.add_argument("--json", default="",
                   help="write the stats dict(s) to this path")
    args = p.parse_args(argv)

    all_stats = {}
    for root in args.root:
        s = corpus_stats(root, args.split, args.sample or None)
        all_stats[root] = s
        print(format_row(os.path.basename(root.rstrip("/")) or root, s))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(all_stats, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
