"""Training entry point: `python -m wireframe_tpu_torch.main`.

The port's counterpart of the repository's `main.py`, with the same flags
and flow plus `--device`: find (or generate) a Building3D corpus, build
the batch loader (`MixedBatchLoader` when `train.cotrain_root` is set),
optionally resume the latest checkpoint under `--checkpoint-dir` or
warm-start from `train.init_from`, train (`train.loop.train_model`), and
write the final checkpoint and, when the run keeps an EMA, the EMA
weights as a params-only checkpoint under `<checkpoint-dir>/ema` that
`wireframe_tpu_torch.evaluate` reads unchanged.  Metrics go to
`<checkpoint-dir>/train_metrics.jsonl`.

Defaults reproduce the reference regime (batch 3, 1000 epochs
overfitting the first shuffled batch, Adam 1e-3); `--config
configs/recommended.yaml` trains the shipped recipe over full epochs.

`--resume` restores params, Adam state, step and epoch; the EMA restarts
from the restored params, as in the JAX package (the EMA trajectory is
not checkpointed).  On a finished run it changes no file.

`--debug-nans` runs training under
`torch.autograd.detect_anomaly(check_nan=True)`: every gradient a
backward node returns is checked, and a NaN raises naming the forward
operation that made it.  Unlike JAX's `jax_debug_nans`, which checks the
output of every operation, it does not check forward values: a NaN made
in the forward shows only when it reaches a gradient, and NaNs outside
autograd (the logged metrics, the optimizer update, the EMA) are not
caught.  It slows every step.

Runs on CUDA; `--device cpu` runs on the CPU with the kernels' plain
versions.  Without a GPU and without `--device cpu` it raises before it
reads or writes anything.

On N GPUs, one process each: `torchrun --nproc_per_node N -m
wireframe_tpu_torch.main ... --set parallel.dp=N` (or the default
parallel.dp=-1).  Each process joins the group `torchrun` describes
(`parallel.mesh.init_distributed`: NCCL on CUDA, gloo with `--device
cpu`) and trains its rows of every global batch (`train.loop`); rank 0
alone finds or generates the corpus and writes the metrics and the
checkpoints.  `--set parallel.mp=M` splits each cloud's points over M
ranks as well (point-parallel training): the N ranks form dp = N / M
row blocks of M, world rank r at dp index r // M and mp index r % M;
data.num_points / M must be a multiple of the training chain's tile
(model.pallas_chain_tile) where the chain runs, and of the query head's
decoder_kv_pool.  E.g. on the CPU: `torchrun --nproc_per_node 2 -m
wireframe_tpu_torch.main ... --set parallel.mp=2 --device cpu`.
Without `torchrun` nothing changes.

Usage:
  python -m wireframe_tpu_torch.main [--config cfg.yaml] [--data-root PATH]
      [--checkpoint-dir DIR] [--set key=val ...] [--resume] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="yaml config path")
    p.add_argument("--data-root", default=None,
                   help="Building3D corpus root (train/ + test/ subdirs)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE", help="config override, repeatable")
    p.add_argument("--wandb", action="store_true",
                   help="log to wandb when available")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly mode with NaN checks (fail fast "
                        "on a NaN gradient)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def resolve_data_root(cli_root, allow_generate=True):
    """Locate (or synthesize) a Building3D corpus.

    Order: explicit --data-root > ./datasets > a synthetic demo corpus
    generated into ./datasets (`wireframe_tpu_torch.tools.gen_demo_data`).
    No path outside the working tree is consulted: point --data-root at a
    real Building3D corpus for benchmark-comparable numbers.
    """
    if cli_root:
        if not os.path.isdir(os.path.join(cli_root, "train", "xyz")):
            raise SystemExit(
                f"--data-root {cli_root!r} has no train/xyz/ directory "
                "(expected Building3D layout: <root>/{train,test}/"
                "{xyz,wireframe})")
        return cli_root
    if os.path.isdir(os.path.join("./datasets", "train", "xyz")):
        return "./datasets"
    if not allow_generate:
        raise SystemExit("No Building3D corpus found; pass --data-root")
    print("No corpus at ./datasets — generating a synthetic demo corpus "
          "(wireframe_tpu_torch.tools.gen_demo_data). Pass --data-root for "
          "real data.")
    from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main

    gen_main(["--out", "datasets"])
    return "./datasets"


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from wireframe_tpu_torch.parallel.mesh import init_distributed, world

    dev = init_distributed(device=args.device)
    rank, size = world()
    try:
        return _train(args, dev, rank, size)
    finally:
        if size > 1:
            torch.distributed.destroy_process_group()


def _train(args, dev, rank: int, size: int) -> int:
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import Building3DDataset
    from wireframe_tpu_torch.data.loader import BatchLoader, MixedBatchLoader
    from wireframe_tpu_torch.parallel.collective_audit import all_reduce
    from wireframe_tpu_torch.train.checkpoint import (
        latest_step,
        restore_train_state,
        save_checkpoint,
        save_params_checkpoint,
        with_buffers,
    )
    from wireframe_tpu_torch.train.loop import init_model, train_model
    from wireframe_tpu_torch.train.metrics_logging import (
        MetricWriter,
        maybe_wandb,
    )
    from wireframe_tpu_torch.train.state import create_train_state

    cfg = load_config(args.config, args.overrides)
    if rank == 0:
        cfg.data.root_dir = resolve_data_root(args.data_root)
    if size > 1:
        # The other ranks look once rank 0 has found or made the corpus.
        all_reduce(torch.zeros(1, device=dev))
        if rank:
            cfg.data.root_dir = resolve_data_root(args.data_root,
                                                  allow_generate=False)
    cfg.train.checkpoint_dir = args.checkpoint_dir

    train_ds = Building3DDataset(cfg.data, "train")
    print(f"Training samples: {len(train_ds)}")
    kw = dict(shuffle=True, drop_last=True, seed=cfg.train.seed,
              augment_on_host=not cfg.train.device_augment)
    if cfg.train.cotrain_root:
        aux_ds = Building3DDataset(
            dataclasses.replace(cfg.data, root_dir=cfg.train.cotrain_root),
            "train")
        print(f"Co-training: {cfg.train.cotrain_count}/"
              f"{cfg.train.batch_size} samples per batch from "
              f"{len(aux_ds)} auxiliary samples at {cfg.train.cotrain_root}")
        loader = MixedBatchLoader(
            train_ds, aux_ds, cfg.train.cotrain_count,
            cfg.train.batch_size, cfg.model.max_vertices, **kw)
    else:
        loader = BatchLoader(train_ds, cfg.train.batch_size,
                             cfg.model.max_vertices, **kw)

    state = None
    start_epoch = 0
    if args.resume and latest_step(args.checkpoint_dir) is not None:
        state = create_train_state(cfg, init_model(cfg, dev))
        state, start_epoch = restore_train_state(state, args.checkpoint_dir)
        print(f"Resuming from epoch {start_epoch} "
              f"(optimizer step {state.step})")
    if start_epoch >= cfg.train.num_epochs:
        # `--resume` on a finished run: nothing to train, nothing to save.
        # Writing here would REPLACE the EMA checkpoint with a copy of the
        # final params (the EMA re-seeds from them on resume).
        print(f"✓ training already complete at epoch {start_epoch}; "
              f"checkpoints left untouched")
        return 0

    # Only rank 0 writes: the metrics, the checkpoints, the W&B run.
    writes = rank == 0
    run = maybe_wandb(config={
        "learning_rate": cfg.train.learning_rate,
        "architecture": "PointCloudToWireframe",
        "dataset": "Building3D",
        "epochs": cfg.train.num_epochs,
    }) if args.wandb and writes else None
    writer = MetricWriter(jsonl_path=os.path.join(
        args.checkpoint_dir, "train_metrics.jsonl"),
        wandb_run=run) if writes else None
    anomaly = (torch.autograd.detect_anomaly(check_nan=True)
               if args.debug_nans else contextlib.nullcontext())
    with anomaly:
        state = train_model(cfg, loader, metric_writer=writer, state=state,
                            start_epoch=start_epoch, device=dev)
    if not writes:
        return 0

    epoch = max(start_epoch, cfg.train.num_epochs)
    path = save_checkpoint(args.checkpoint_dir, state, cfg, epoch=epoch)
    print(f"✓ checkpoint saved: {path}")
    if state.ema_params is not None:
        # EMA weights as a drop-in checkpoint: `evaluate --checkpoint-dir
        # <dir>/ema` consumes it unchanged.
        ema_path = save_params_checkpoint(
            os.path.join(args.checkpoint_dir, "ema"), state.step,
            with_buffers(state.model, state.ema_params), cfg, epoch=epoch)
        print(f"✓ EMA checkpoint saved: {ema_path}")
    if run is not None:
        # Cross-script linkage the reference maintains (main.py:57-61).
        with open(os.path.join(args.checkpoint_dir, "wandb_run_id.txt"),
                  "w") as f:
            f.write(run.id)
        print(f"✓ W&B run ID saved: {run.id}")
    writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
