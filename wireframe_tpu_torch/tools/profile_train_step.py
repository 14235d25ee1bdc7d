"""Decompose the train step's time into its parts, on one GPU.

Port of the repository's `tools/profile_train_step.py`.  Times, each
chained through one device scalar over `--iters` calls and read back once
(so the host never waits inside the window;
`utils.profiling.chained_seconds`):
  - the full train step (the `BENCH_TRAIN` number);
  - the forward only (`train.step.make_forward_fn`, inference mode);
  - the encoder's forward + backward alone: the model's encoder in train
    mode and autograd to its parameters, that is the chain kernels (K2 +
    K3 with `model.chain_backward=stash`, K5 with `remat`);
  - the assignment alone: K4 on (B, V, V) random costs;
and prints each as a share of the full step, then one JSON line with the
same numbers, last on stdout.

Usage (CUDA; `--device cpu` runs the plain versions on the CPU, and
without a GPU and without it the tool raises):
  python -m wireframe_tpu_torch.tools.profile_train_step [--batch 16]
      [--points 2560] [--config configs/recommended.yaml] [--iters 20]
      [--set k.e.y=v ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from wireframe_tpu_torch.config import RECIPE_YAML
from wireframe_tpu_torch.utils.profiling import chained_seconds

WARMUP = 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--points", type=int, default=2560)
    p.add_argument("--config", default=str(RECIPE_YAML))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.ops.lockstep_lsa import solve_lsa_rows
    from wireframe_tpu_torch.train.loop import device_batch, init_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import (
        make_forward_fn,
        make_train_step,
    )
    from wireframe_tpu_torch.utils.platform import card_line, resolve_device
    from wireframe_tpu_torch.utils.synth import make_random_batch

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    cfg.data.num_points = args.points
    cfg.train.device_augment = False
    cfg.__post_init__()
    b, n, v = args.batch, args.points, cfg.model.max_vertices
    batch = device_batch(make_random_batch(cfg, b), dev)
    state = create_train_state(cfg, init_model(cfg, dev, seed=0))
    model = state.model
    results = {}

    # 1. The full train step; the state threads through every step.
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def full_chain(s, i):
        _, m = step(state, batch, gen)
        return s + m["total_loss"]

    results["full_step"] = chained_seconds(
        full_chain, args.iters, dev, warmup=WARMUP)

    # 2. The forward only (the input perturbed by s * 0 chains the calls).
    fwd = make_forward_fn(cfg)

    def fwd_chain(s, i):
        o = fwd(model, batch["point_clouds"] + s * 0.0,
                batch["vertex_counts"])
        return s + o["vertices"].float().sum() + o["edge_probs"].sum()

    results["forward_only"] = chained_seconds(
        fwd_chain, args.iters, dev, warmup=WARMUP)

    # 3. The encoder's forward + backward: the chain kernels.
    enc = model.encoder
    enc_params = list(enc.parameters())

    def enc_chain(s, i):
        g, pooled, feats = enc(batch["point_clouds"] + s * 0.0, train=True)
        loss = (g.mean() + pooled["masked_max"].mean()
                + pooled["masked_mean"].mean())
        if "kv" in pooled:
            loss = loss + pooled["kv"].mean()
        if feats is not None:
            loss = loss + feats.mean()
        # The gradients are queued on the same stream as the scalar, so
        # the final read-back waits for them too.
        torch.autograd.grad(loss, enc_params, allow_unused=True)
        return s + loss.detach()

    results["encoder_fwd_bwd"] = chained_seconds(
        enc_chain, args.iters, dev, warmup=WARMUP)

    # 4. The assignment alone (K4), as the loss calls it: targets as rows.
    cost = torch.from_numpy(np.random.default_rng(0).random(
        (b, v, v)).astype(np.float32)).to(dev)
    counts = batch["vertex_counts"].to(torch.int32)

    def lsa_chain(s, i):
        c = (cost + s * 0.0).transpose(1, 2).contiguous()
        return s + solve_lsa_rows(c, counts).sum().float()

    results["lsa_matching"] = chained_seconds(
        lsa_chain, args.iters, dev, warmup=WARMUP)

    full = results["full_step"]
    card = card_line(dev)
    print(f"config: vertex_head={cfg.model.vertex_head} "
          f"dtype={cfg.model.compute_dtype} chain_backward="
          f"{cfg.model.chain_backward} B={b} N={n} V={v} [{card}]")
    for k, t in results.items():
        print(f"{k:>18}: {t * 1e3:8.2f} ms  ({t / full * 100:5.1f}% of step)")
    print(f"{'clouds/sec':>18}: {b / full:8.1f}")
    print(json.dumps({
        "metric": "train_step_decomposition", "device": card,
        "config": args.config, "batch": b, "points": n,
        "chain_backward": cfg.model.chain_backward,
        "ms": {k: t * 1e3 for k, t in results.items()},
        "share_of_step": {k: t / full for k, t in results.items()},
        "clouds_per_sec": b / full}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
