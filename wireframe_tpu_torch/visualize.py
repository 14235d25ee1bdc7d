"""Visualization entry point: `python -m wireframe_tpu_torch.visualize`.

The port's counterpart of the repository's `visualize.py`, with its flags
plus `--device`: renders per-sample PNGs under --out-dir, a 3-panel
GT-vs-prediction comparison (`<out-dir>/<scan_idx>/comparison.png`) and
an edge-probability plot (`edge_probs.png`), with each sample's corner and
edge F1 from the Building3D AP stack, and with `--loss-curve` the
training loss curves of `<checkpoint-dir>/train_metrics.jsonl`
(`<out-dir>/training_loss.png`).  Sample selection is by flags
(`--samples 0,3,7` or `--samples all`); `--interactive` prompts for the
split and the samples.

The forward is `train.step.make_forward_fn`'s on the model of
`eval.evaluator.build_model` (the evaluator's inference forward, which
also returns the pair mask the edge plot reads), one sample a call;
decoding is `eval.decode.decode_predictions`, scoring the port's
`APCalculator`.  One generator, `default_rng(data.seed)`, draws the
point sampling of the selected samples in order, as in `visualize.py`.

matplotlib is imported inside `main` (through `viz`), never at import
time.  Runs on CUDA; `--device cpu` runs on the CPU.  The card's machine
has no matplotlib, so there it stops at that import; run it where
matplotlib is installed.

Usage:
  python -m wireframe_tpu_torch.visualize [--split test] [--samples all]
      [--out-dir output] [--checkpoint-dir checkpoints] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--samples", default="all",
                   help="comma-separated indices or 'all'")
    p.add_argument("--out-dir", default="output")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--loss-curve", action="store_true",
                   help="also render the training loss curves from "
                        "<checkpoint-dir>/train_metrics.jsonl")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import (
        Building3DDataset,
        collate_fixed,
        edge_endpoint_array,
    )
    from wireframe_tpu_torch.eval.decode import decode_predictions
    from wireframe_tpu_torch.eval.evaluator import build_model
    from wireframe_tpu_torch.main import resolve_data_root
    from wireframe_tpu_torch.metrics.ap_calculator import APCalculator
    from wireframe_tpu_torch.train.checkpoint import (
        apply_checkpoint_model_config,
        load_checkpoint,
    )
    from wireframe_tpu_torch.train.step import make_forward_fn
    from wireframe_tpu_torch.utils.platform import resolve_device
    from wireframe_tpu_torch.viz import (
        plot_edge_probabilities,
        plot_prediction_comparison,
        plot_training_loss,
    )

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    cfg.data.root_dir = resolve_data_root(args.data_root)

    if args.loss_curve:
        jsonl = os.path.join(args.checkpoint_dir, "train_metrics.jsonl")
        if os.path.exists(jsonl):
            with open(jsonl) as f:
                history = [json.loads(line) for line in f]
            os.makedirs(args.out_dir, exist_ok=True)
            out = os.path.join(args.out_dir, "training_loss.png")
            plot_training_loss(history, save_path=out)
            print(f"loss curves -> {out}")
        else:
            print(f"no metrics at {jsonl}")

    payload, meta = load_checkpoint(args.checkpoint_dir, args.step)
    apply_checkpoint_model_config(cfg, meta)

    if args.interactive:
        args.split = input("dataset split [train/test]: ").strip() or "test"

    dataset = Building3DDataset(cfg.data, args.split)
    if args.interactive:
        raw = input(f"sample indices 0..{len(dataset)-1} (comma) or 'all': ")
        args.samples = raw.strip() or "all"
    if args.samples == "all":
        indices = list(range(len(dataset)))
    else:
        indices = [int(s) for s in args.samples.split(",")]

    model = build_model(cfg, payload["params"], dev)
    forward = make_forward_fn(cfg)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(cfg.data.seed)
    v = cfg.model.max_vertices

    for i in indices:
        sample = dataset.get_sample(i, rng=rng, augment_on_host=False)
        batch = collate_fixed([sample], v)
        out = forward(model, torch.from_numpy(batch["point_clouds"]).to(dev))
        preds = {k: t[0].cpu().numpy() for k, t in out.items()}
        count = int(preds["actual_vertex_counts"])
        probs = preds["edge_probs"]
        live = (preds["existence_probabilities"]
                > cfg.eval.vertex_existence_thresh
                if cfg.model.slot_mask_mode == "existence" else None)
        dec = decode_predictions(
            preds["vertices"], probs, count, v,
            cfg.eval.edge_confidence_thresh, live_mask=live)

        # Per-sample metrics via the same AP stack as evaluate.
        ap = APCalculator(distance_thresh=cfg.eval.distance_thresh)
        gt_v = batch["wf_vertices"][0]
        gt_e = batch["wf_edges"][0].astype(np.int64)
        ap.compute_metrics({
            "predicted_vertices": [dec["vertices"]],
            "predicted_edges": [dec["edges"]],
            "pred_edges_vertices": [dec["edges_vertices"]],
            "wf_vertices": [gt_v],
            "wf_edges": [gt_e],
            "wf_edges_vertices": [
                edge_endpoint_array(np.asarray(gt_v, np.float64), gt_e)],
        })
        m = ap.summarize()

        sample_dir = os.path.join(args.out_dir, str(batch["scan_idx"][0]))
        os.makedirs(sample_dir, exist_ok=True)
        plot_prediction_comparison(
            sample["point_clouds"], gt_v, gt_e,
            dec["vertices"][:count], dec["edges"], metrics=m,
            save_path=os.path.join(sample_dir, "comparison.png"))
        plot_edge_probabilities(
            probs[preds["pair_mask"]],
            threshold=cfg.eval.edge_confidence_thresh,
            save_path=os.path.join(sample_dir, "edge_probs.png"))
        print(f"sample {i} (scan {batch['scan_idx'][0]}): "
              f"C-F1 {m['corners_f1']:.3f} E-F1 {m['edges_f1']:.3f} "
              f"-> {sample_dir}/")

    print(f"✓ visualizations written to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
