"""Inference entry point: `python -m wireframe_tpu_torch.test`.

The port's counterpart of the repository's `test.py`: runs a trained
port checkpoint over a split, writes the predicted wireframes as
Wavefront `.obj` files de-normalized back to world coordinates, and
prints per-sample vertex / edge counts.  One generator,
`default_rng(data.seed)`, draws the point sampling of the whole split in
order (unlike `evaluate`, which keys one per sample).  In the existence
slot-mask mode the live slots are written compacted, the edges
re-indexed into them; in the prefix mode the first `count` slots are
written with the edges among them.

Runs on CUDA; `--device cpu` runs on the CPU.

Usage:
  python -m wireframe_tpu_torch.test [--checkpoint-dir checkpoints]
      [--data-root PATH] [--split test] [--out-dir predictions]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--split", default="test", choices=("train", "test"))
    p.add_argument("--out-dir", default="predictions")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import (
        Building3DDataset,
        collate_fixed,
    )
    from wireframe_tpu_torch.eval.decode import decode_wireframe
    from wireframe_tpu_torch.eval.evaluator import make_forward_fn
    from wireframe_tpu_torch.io.obj import save_wireframe
    from wireframe_tpu_torch.main import resolve_data_root
    from wireframe_tpu_torch.train.checkpoint import (
        apply_checkpoint_model_config,
        load_checkpoint,
    )
    from wireframe_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    cfg.data.root_dir = resolve_data_root(args.data_root)
    payload, meta = load_checkpoint(args.checkpoint_dir, args.step)
    apply_checkpoint_model_config(cfg, meta)

    dataset = Building3DDataset(cfg.data, args.split)
    forward = make_forward_fn(cfg, payload["params"], dev)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(cfg.data.seed)
    bs = cfg.eval.batch_size

    for k in range(0, len(dataset), bs):
        idxs = list(range(k, min(k + bs, len(dataset))))
        samples = [dataset.get_sample(i, rng=rng, augment_on_host=False)
                   for i in idxs]
        batch = collate_fixed(samples, cfg.model.max_vertices)
        preds = forward(batch["point_clouds"])
        for j in range(len(idxs)):
            out_verts, edges = decode_wireframe(
                cfg, preds["vertices"][j], preds["edge_probs"][j],
                int(preds["actual_vertex_counts"][j]),
                preds["existence_probabilities"][j])
            # De-normalize back to the original (UTM) frame.
            out_verts = (out_verts * batch["max_distance"][j]
                         + batch["centroid"][j])
            name = f"{batch['scan_idx'][j]}.obj"
            save_wireframe(out_verts, edges, os.path.join(args.out_dir, name))
            print(f"{name}: {len(out_verts)} vertices, {len(edges)} edges")

    print(f"✓ wireframes written to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
