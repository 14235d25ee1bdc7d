"""Evaluation entry point: `python -m wireframe_tpu_torch.evaluate`.

The port's counterpart of the repository's `evaluate.py`, with its flags
plus `--device`: loads a port checkpoint (the latest under
`--checkpoint-dir`, or `--step`; `export_port_checkpoint.py` writes one
from a JAX package's checkpoint), takes the model's architecture from it,
runs batched inference over a split and prints the Building3D metrics
(ACO, corner P/R/F1, edge P/R/F1, WED) with the same names and threshold
defaults (distance 1.0, edge confidence 0.5).

Paths: the plain evaluator (host float64 Hausdorff), `--device-hausdorff`
(float32 Hausdorff matrices in one padded device batch), `--raw-points`
(full clouds, bucketed), `--pipelined` (the fixed-shape dispatch-ahead
pipeline, counters equal to `--device-hausdorff`'s at the same batch),
`--sharded N` (`eval.distributed.evaluate_model_sharded` in this
process: N round-robin shards, evaluated shard by shard or, with
`--pipelined`, in one pass; the counters equal the unsharded run's on
the same path, bit for bit).  `--torch-checkpoint PTH` evaluates the
reference's own `trained_model.pth` instead, transplanted into the
parity model (MLP head, prefix slot masks, raw intensity, max_vertices
from its final layer), as the repository's `evaluate.py` does.

Runs on CUDA; `--device cpu` runs on the CPU.

Usage:
  python -m wireframe_tpu_torch.evaluate [--checkpoint-dir checkpoints]
      [--data-root PATH] [--set key=val ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--torch-checkpoint", default=None, metavar="PTH",
                   help="evaluate a reference PyTorch trained_model.pth "
                        "via full weight transplantation instead of a "
                        "port checkpoint")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--split", default="test", choices=("train", "test"))
    p.add_argument("--raw-points", action="store_true",
                   help="evaluate on full unsampled clouds via bucketed "
                        "batching instead of num_points sampling")
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="evaluate via the sharded path "
                        "(eval.distributed.evaluate_model_sharded) with N "
                        "shards; counters merge exactly, so metrics match "
                        "the unsharded run")
    p.add_argument("--device-hausdorff", action="store_true",
                   help="compute pred-vs-GT edge Hausdorff matrices in one "
                        "padded device batch instead of host numpy")
    p.add_argument("--pipelined", action="store_true",
                   help="run the fused fixed-shape eval pipeline "
                        "(eval/pipeline.py): dispatch-ahead readback; "
                        "counters match --device-hausdorff's")
    p.add_argument("--eval-batch", type=int, default=64,
                   help="device batch for --pipelined (default 64)")
    p.add_argument("--qmax", type=int, default=128,
                   help="--pipelined pad for kept predicted edges per "
                        "sample (overflow falls back to the host decode)")
    p.add_argument("--emax", type=int, default=64,
                   help="--pipelined pad for GT edges per sample "
                        "(overflow falls back to the plain device "
                        "Hausdorff helper)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    run(argv)
    return 0


def run(argv=None):
    """Everything `main` does; returns the APCalculator holding the run's
    raw counters and sample count."""
    args = parse_args(argv)
    if args.sharded and args.raw_points:
        raise SystemExit("--sharded does not support --raw-points yet")

    from wireframe_tpu_torch.bridge import flatten_params
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import Building3DDataset
    from wireframe_tpu_torch.eval.distributed import evaluate_model_sharded
    from wireframe_tpu_torch.eval.evaluator import evaluate_model
    from wireframe_tpu_torch.eval.pipeline import evaluate_corpus_pipelined
    from wireframe_tpu_torch.main import resolve_data_root
    from wireframe_tpu_torch.metrics.ap_calculator import APCalculator
    from wireframe_tpu_torch.train.checkpoint import (
        apply_checkpoint_model_config,
        load_checkpoint,
        load_torch_checkpoint_as_params,
    )
    from wireframe_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    cfg.data.root_dir = resolve_data_root(args.data_root)
    if args.torch_checkpoint:
        params, max_vertices = load_torch_checkpoint_as_params(
            args.torch_checkpoint, num_heads=cfg.model.edge_num_heads)
        payload = {"params": flatten_params(params)}
        # The reference model's config: MLP head, prefix slots, raw
        # intensity (it never rescales), V from the final layer.
        cfg.data.max_vertices = max_vertices
        cfg.model.vertex_head = "mlp"
        cfg.model.slot_mask_mode = "prefix"
        cfg.data.scale_intensity = False
        cfg.__post_init__()
    else:
        payload, meta = load_checkpoint(args.checkpoint_dir, args.step)
        # The architecture comes from the checkpoint's metadata.
        apply_checkpoint_model_config(cfg, meta)

    dataset = Building3DDataset(cfg.data, args.split)
    ap = APCalculator(distance_thresh=cfg.eval.distance_thresh,
                      confidence_thresh=cfg.eval.edge_confidence_thresh)
    print(f"Evaluating {len(dataset)} samples from '{args.split}'"
          + (" (raw clouds, bucketed)" if args.raw_points else ""))
    if args.sharded:
        evaluate_model_sharded(
            cfg, payload["params"], dataset, n_shards=args.sharded,
            device_hausdorff=args.device_hausdorff, verbose=True,
            pipelined=args.pipelined,
            pipeline_kwargs={"batch": args.eval_batch,
                             "qmax": args.qmax, "emax": args.emax},
            ap=ap, device=dev)
    elif args.pipelined:
        if args.raw_points:
            raise SystemExit("--pipelined does not support --raw-points")
        stats = {}
        evaluate_corpus_pipelined(cfg, payload["params"], dataset,
                                  batch=args.eval_batch, qmax=args.qmax,
                                  emax=args.emax, verbose=True,
                                  ap=ap, stats=stats, device=dev)
        if stats.get("qmax_overflows") or stats.get("emax_overflows"):
            print(f"pipeline pad overflows (host-helper fallbacks): "
                  f"qmax={stats['qmax_overflows']} "
                  f"emax={stats['emax_overflows']}")
    else:
        evaluate_model(cfg, payload["params"], dataset,
                       raw_points=args.raw_points,
                       device_hausdorff=args.device_hausdorff, ap=ap,
                       device=dev)
    return ap


if __name__ == "__main__":
    sys.exit(main())
