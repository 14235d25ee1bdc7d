"""Calibrate decision thresholds on the TRAIN split.

The port's copy of `tools/calibrate_threshold.py`: the same sweeps, table
and test-split line, over the port's pipelined eval
(`eval.pipeline.evaluate_corpus_pipelined`, batch 8, qmax 128, emax 64).

The reference hard-codes the edge-confidence threshold at 0.5
(evaluate.py:81) and the vertex-existence threshold at 0.5
(PointCloudToWireframe.py:90).  This sweeps one or both on the train
split (never the test split — that would be test-set fitting), reports
the full metric table, and prints the test-split metrics at the
calibrated values.

`--param joint` does one coordinate-descent pass: sweep the vertex
threshold at the current edge threshold (selecting by corners_f1),
then the edge threshold at the calibrated vertex value (selecting by
--metric, default edges_f1).  The vertex threshold only has an effect
in `model.slot_mask_mode=existence` runs (the query-head recipe).

Runs on CUDA; `--device cpu` runs on the CPU.

Usage:
  python -m wireframe_tpu_torch.tools.calibrate_threshold \\
      --checkpoint-dir ck [--data-root PATH] [--param edge|vertex|joint] \\
      [--thresholds 0.2,0.3,...] [--vertex-thresholds 0.3,...]
"""

from __future__ import annotations

import argparse
import json
import sys

HEADER = (f"{'thresh':>7} {'C-P':>7} {'C-R':>7} {'C-F1':>7} {'ACO':>7} "
          f"{'E-P':>7} {'E-R':>7} {'E-F1':>7} {'WED':>7}")


def _row(t, m):
    return (f"{t:7.2f} {m['corners_precision']:7.3f} "
            f"{m['corners_recall']:7.3f} {m['corners_f1']:7.3f} "
            f"{m['average_corner_offset']:7.3f} {m['edges_precision']:7.3f} "
            f"{m['edges_recall']:7.3f} {m['edges_f1']:7.3f} "
            f"{m['average_wed']:7.3f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--data-root", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--param", default="edge",
                   choices=("edge", "vertex", "joint"))
    p.add_argument("--thresholds",
                   default="0.2,0.3,0.4,0.5,0.6,0.7",
                   help="edge-threshold sweep values")
    p.add_argument("--vertex-thresholds",
                   default="0.3,0.4,0.5,0.6,0.7,0.8,0.9",
                   help="vertex-existence sweep values")
    p.add_argument("--metric", default="edges_f1",
                   help="edge-sweep selection metric (default edges_f1)")
    p.add_argument("--vertex-metric", default="corners_f1",
                   help="vertex-sweep selection metric (default corners_f1)")
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--json-out", default=None,
                   help="write calibrated thresholds + test metrics as JSON")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import Building3DDataset
    from wireframe_tpu_torch.eval.pipeline import evaluate_corpus_pipelined
    from wireframe_tpu_torch.main import resolve_data_root
    from wireframe_tpu_torch.train.checkpoint import (
        apply_checkpoint_model_config,
        load_checkpoint,
    )
    from wireframe_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    cfg.data.root_dir = resolve_data_root(args.data_root)
    payload, meta = load_checkpoint(args.checkpoint_dir)
    apply_checkpoint_model_config(cfg, meta)

    train_ds = Building3DDataset(cfg.data, "train")
    test_ds = Building3DDataset(cfg.data, "test")

    # Every eval rides the pipelined path (counters equal to the plain
    # evaluator's device-Hausdorff path at the same batch); the thresholds
    # are read when its step is made, so each sweep value makes its own.
    def run_eval(dataset):
        return evaluate_corpus_pipelined(cfg, payload["params"], dataset,
                                         batch=8, qmax=128, emax=64,
                                         device=dev)

    def sweep(key, values, select_metric):
        """Sweep cfg.eval.<key> over values on the train split."""
        print(f"\nSweeping {key} on {len(train_ds)} train samples "
              f"(select by {select_metric})")
        print(HEADER)
        best_t, best_val = None, -1.0
        for t in values:
            setattr(cfg.eval, key, t)
            m = run_eval(train_ds)
            print(_row(t, m), flush=True)
            if m[select_metric] > best_val:
                best_t, best_val = t, m[select_metric]
        setattr(cfg.eval, key, best_t)
        print(f"Best train-split {select_metric}: {best_val:.3f} "
              f"at {key}={best_t}")
        return best_t

    edge_vals = [float(t) for t in args.thresholds.split(",")]
    vert_vals = [float(t) for t in args.vertex_thresholds.split(",")]

    if args.param in ("vertex", "joint"):
        if cfg.model.slot_mask_mode != "existence":
            print(f"NOTE: slot_mask_mode={cfg.model.slot_mask_mode!r} — "
                  "the vertex threshold has no effect outside 'existence' "
                  "mode; sweeping anyway for the record.")
        sweep("vertex_existence_thresh", vert_vals, args.vertex_metric)
    if args.param in ("edge", "joint"):
        sweep("edge_confidence_thresh", edge_vals, args.metric)

    print(f"\nTest split at calibrated thresholds "
          f"(vertex={cfg.eval.vertex_existence_thresh}, "
          f"edge={cfg.eval.edge_confidence_thresh}):")
    m = run_eval(test_ds)
    print(HEADER)
    print(_row(cfg.eval.edge_confidence_thresh, m))
    print(f"\n(reference hard-codes 0.5/0.5 — pass "
          f"`--set eval.vertex_existence_thresh="
          f"{cfg.eval.vertex_existence_thresh} "
          f"eval.edge_confidence_thresh={cfg.eval.edge_confidence_thresh}` "
          "to evaluate to reproduce)")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({
                "vertex_existence_thresh": cfg.eval.vertex_existence_thresh,
                "edge_confidence_thresh": cfg.eval.edge_confidence_thresh,
                "live_corner_filter": cfg.eval.live_corner_filter,
                "test_metrics": {k: float(v) for k, v in m.items()},
            }, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
