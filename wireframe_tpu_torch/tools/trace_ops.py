"""Per-kernel train-step anatomy from a torch.profiler trace, on one GPU.

Port of the repository's `tools/trace_ops.py`.  Profiles N train steps
(`utils.profiling.trace`, CPU + CUDA activities), reads the exported
Chrome trace back, sums the device time of every kernel, copy and memset
by name, and sorts the names into groups (`GROUPS`): the port's kernels
K1, K2/K3/K5 and K4, the library GEMMs, attention / softmax, elementwise
/ reduce, copy / cast and the rest, so the step's milliseconds have names.
When it captures the trace itself it also prints the profiler's own
device total (`utils.profiling.device_rows`), which the groups must sum
to.

Usage (CUDA; `--device cpu` runs on the CPU, where the trace holds no
device events; without a GPU and without it the tool raises):
  python -m wireframe_tpu_torch.tools.trace_ops [--batch 64]
      [--config configs/recommended.yaml] [--steps 6] [--top 40]
      [--json OUT] [--set k.e.y=v ...] [--device cpu]
  python -m wireframe_tpu_torch.tools.trace_ops --trace-dir DIR --steps N
      # parse a trace that exists (N: the steps it holds)
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

from wireframe_tpu_torch.config import RECIPE_YAML

# Chrome-trace categories of the events that ran on the card.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

GROUPS = (
    # (label, regex over the device kernel name), first match wins.  The
    # port's kernels come first: csrc/lockstep_lsa.cu's lsa_kernel (K4);
    # K1's own kernels, the pool finalize and the projection GEMM with
    # the POOL epilogue (hgemm's wgmma_chain_kernel<0, 3, ...>); then the
    # chain's kernels (csrc/chain_grad.cu + hopper_gemm.cuh).  K1's stage
    # GEMMs and input prep are K5's forward kernels, so a forward trace
    # counts them under the chain; a train step runs no K1.
    ("K4 (lockstep JV)", re.compile(r"lsa_kernel")),
    ("K1 (fused encoder)", re.compile(
        r"k1_finalize|wgmma_chain_kernel<0, 3")),
    ("K2/K3/K5 (encoder chain)", re.compile(
        r"wgmma_chain_kernel|prep_x_kernel|window_pool_kernel|seed_kernel"
        r"|colsum_kernel")),
    ("library GEMM (cuBLAS / CUTLASS)", re.compile(
        r"gemm|gemv|nvjet|cutlass|cublas|xmma|splitKreduce|dot_kernel",
        re.I)),
    ("attention / softmax", re.compile(
        r"softmax|attention|fmha|flash|sdpa", re.I)),
    ("copy / cast", re.compile(
        r"^Memcpy|^Memset|copy_kernel|direct_copy|CatArray|memcpy|memset",
        re.I)),
    ("elementwise / reduce", re.compile(
        r"elementwise|reduce|foreach|multi_tensor|norm|index|scatter"
        r"|gather|where|sort|scan|argmax|max_|sum_|fill", re.I)),
)


def classify(name: str) -> str:
    for label, pat in GROUPS:
        if pat.search(name):
            return label
    return "other"


def aggregate_device_events(trace_dir: str):
    """(name -> total us, event count) over the device events of every
    Chrome trace (`*.json`) in trace_dir."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {trace_dir}")
    totals = collections.Counter()
    n_events = 0
    for path in paths:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
                totals[ev["name"]] += float(ev.get("dur", 0.0))
                n_events += 1
    if n_events == 0:
        print("WARNING: no device events in the trace (a CPU run has none; "
              "run on the card)", file=sys.stderr)
    return totals, n_events


def capture(args, trace_dir: str) -> float:
    """Profile args.steps train steps into trace_dir; returns the
    profiler's device total in ms per step (0 on the CPU)."""
    import torch

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.train.loop import device_batch, init_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.platform import card_line, resolve_device
    from wireframe_tpu_torch.utils.profiling import device_rows, trace
    from wireframe_tpu_torch.utils.synth import make_random_batch

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    cfg.data.num_points = args.points
    cfg.train.device_augment = False
    cfg.__post_init__()
    batch = device_batch(make_random_batch(cfg, args.batch), dev)
    state = create_train_state(cfg, init_model(cfg, dev, seed=0))
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # Warm up (kernel builds, allocator) outside the trace window.
    state, m = step(state, batch, gen)
    float(m["total_loss"])
    t0 = time.perf_counter()
    with trace(trace_dir) as prof:
        for _ in range(args.steps):
            state, m = step(state, batch, gen)
        float(m["total_loss"])      # the read-back waits for every step
    wall = (time.perf_counter() - t0) / args.steps
    device_ms = sum(r[0] for r in device_rows(prof)) / args.steps
    print(f"captured {args.steps} steps at batch {args.batch} x "
          f"{args.points}, wall {wall * 1e3:.2f} ms/step (profiler on), "
          f"profiler device total {device_ms:.3f} ms/step "
          f"[{card_line(dev)}]", file=sys.stderr)
    return device_ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--points", type=int, default=2560)
    p.add_argument("--config", default=str(RECIPE_YAML))
    p.add_argument("--steps", type=int, default=None,
                   help="steps to capture (default 6); REQUIRED with "
                        "--trace-dir, where it states how many steps the "
                        "trace holds (per-step numbers are totals divided "
                        "by it)")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--json", default=None)
    p.add_argument("--trace-dir", default=None,
                   help="parse an existing trace instead of capturing one "
                        "(a captured trace goes to a temporary directory "
                        "that is removed at the end)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    trace_dir = args.trace_dir
    if trace_dir is not None and args.steps is None:
        p.error("--trace-dir needs an explicit --steps (the step count "
                "the trace was captured with); guessing would mis-scale "
                "every ms/step number")
    if args.steps is None:
        args.steps = 6
    profiler_ms = None
    if trace_dir is None:
        with tempfile.TemporaryDirectory(prefix="wf_trace_") as trace_dir:
            profiler_ms = capture(args, trace_dir)
            totals, n_events = aggregate_device_events(trace_dir)
    else:
        totals, n_events = aggregate_device_events(trace_dir)
    per_step = {k: v / args.steps for k, v in totals.items()}
    total_us = sum(per_step.values())
    groups = collections.Counter()
    for name, us in per_step.items():
        groups[classify(name)] += us

    print(f"\n== device time: {total_us / 1e3:.3f} ms/step over {n_events} "
          f"events ==")
    for label, us in groups.most_common():
        share = us / total_us * 100 if total_us else float("nan")
        print(f"  {label:<34} {us / 1e3:8.3f} ms  ({share:5.1f}%)")
    print(f"\n== top {args.top} kernels (ms/step) ==")
    rows = sorted(per_step.items(), key=lambda kv: -kv[1])[:args.top]
    for name, us in rows:
        print(f"  {us / 1e3:8.3f}  [{classify(name)}] {name[:100]}")

    result = {"metric": "train_step_device_time_by_group",
              "steps": args.steps, "events": n_events,
              "total_ms": total_us / 1e3,
              "profiler_device_ms": profiler_ms,
              "groups_ms": {k: v / 1e3 for k, v in groups.items()},
              "ops_ms": {k: v / 1e3 for k, v in rows}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"\nwrote {args.json}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
