"""Per-kernel train-step anatomy from a torch.profiler trace, on one GPU.

Port of the repository's `tools/trace_ops.py`.  Profiles N train steps
(`utils.profiling.trace`, CPU + CUDA activities), reads the exported
Chrome trace back, sums the device time of every kernel, copy and memset
by name, and sorts the names into groups (`GROUPS`): the port's kernels
K1, K2/K3/K5, K4, the pair MLP, PTv3's maps and convs and PTv2's kNN,
the library GEMMs, attention / softmax, elementwise / reduce, copy /
cast and the rest, so the step's milliseconds have names.
When it captures the trace itself it also prints the profiler's own
device total (`utils.profiling.device_rows`), which the groups must sum
to.

Beside the groups it splits the device time by the program's spans
(`utils.profiling.span`, "wf.<name>" ranges): an event counts under every
span open on the host when it was launched (inclusive), and under the
innermost of them alone (self).  The launch is the runtime or driver call
with the event's correlation id, else the host event its External id
names; the match is by time over every thread, since autograd launches
the backward from a thread of its own while the caller waits inside the
"backward" span.  Events launched under no span count as "(no span)",
events whose launch is not in the trace as "(launch not found)".

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
# ... and of the host calls that launch them.
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# ... and of the host operations an External id names.
HOST_CATEGORIES = ("cpu_op", "user_annotation")
NO_SPAN, NOT_FOUND = "(no span)", "(launch not found)"

GROUPS = (
    # (label, regex over the device kernel name), first match wins.  The
    # port's kernels come first: csrc/lockstep_lsa.cu's lsa_kernel (K4);
    # K1's own kernels, the pool finalize and the projection GEMM with
    # the POOL epilogue (hgemm's wgmma_chain_kernel<0, 3, ...>); then the
    # chain's kernels (csrc/chain_grad.cu + hopper_gemm.cuh).  K1's stage
    # GEMMs and input prep are K5's forward kernels, so a forward trace
    # counts them under the chain; a train step runs no K1.  The edge
    # head's pair MLP at inference is csrc/pair_mlp.cu's pair_mlp_kernel;
    # PTv3's neighbour maps and submanifold convs, csrc/neighbour_map.cu's
    # and csrc/subm_conv.cu's kernels; PTv2's kNN search, csrc/knn.cu's,
    # and its grouped vector attention, csrc/gva.cu's.
    ("K4 (lockstep JV)", re.compile(r"lsa_kernel")),
    ("K1 (fused encoder)", re.compile(
        r"k1_finalize|wgmma_chain_kernel<0, 3")),
    ("K2/K3/K5 (encoder chain)", re.compile(
        r"wgmma_chain_kernel|prep_x_kernel|window_pool_kernel|seed_kernel"
        r"|colsum_kernel")),
    ("pair MLP (edge head)", re.compile(r"pair_mlp_kernel")),
    ("PTv3 maps and convs", re.compile(
        r"nbr_table_kernel|nbr_query_kernel|subm_conv_kernel")),
    ("PTv2 kNN", re.compile(r"knn_kernel")),
    ("PTv2 GVA", re.compile(r"gva_kernel")),
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


def _host_times(events):
    """(spans, launch, named) of one trace: the program's spans as
    (duration, name, start, end), innermost first; the host time of each
    runtime or driver call by correlation id; and of the first host op
    with each External id."""
    from wireframe_tpu_torch.utils.profiling import SPAN_PREFIX

    spans, launch, named = [], {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        cat, ts = ev.get("cat"), float(ev.get("ts", 0.0))
        if cat == "user_annotation" and str(
                ev.get("name", "")).startswith(SPAN_PREFIX):
            dur = float(ev.get("dur", 0.0))
            spans.append((dur, ev["name"][len(SPAN_PREFIX):], ts, ts + dur))
        if cat in LAUNCH_CATEGORIES and "correlation" in args:
            launch[args["correlation"]] = ts
        elif cat in HOST_CATEGORIES and "External id" in args:
            named.setdefault(args["External id"], ts)
    spans.sort()
    return spans, launch, named


def aggregate_device_events(trace_dir: str):
    """(name -> total us, event count, span -> inclusive us, span ->
    {name -> self us}) over the device events of every Chrome trace
    (`*.json`) in trace_dir, each read once.  An event counts under the
    spans open at its launch (module docstring); NO_SPAN and NOT_FOUND
    hold the rest."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {trace_dir}")
    totals = collections.Counter()
    inclusive = collections.Counter()
    own = collections.defaultdict(collections.Counter)
    n_events = 0
    for path in paths:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        spans, launch, named = _host_times(events)
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
                continue
            args = ev.get("args") or {}
            us = float(ev.get("dur", 0.0))
            totals[ev["name"]] += us
            n_events += 1
            t = launch.get(args.get("correlation"),
                           named.get(args.get("External id")))
            if t is None:
                open_ = [NOT_FOUND]
            else:
                open_ = ([n for _, n, a, b in spans if a <= t <= b]
                         or [NO_SPAN])
            for n in set(open_):
                inclusive[n] += us
            own[open_[0]][ev["name"]] += us
    if n_events == 0:
        print("WARNING: no device events in the trace (a CPU run has none; "
              "run on the card)", file=sys.stderr)
    return totals, n_events, inclusive, own


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
            totals, n_events, span_us, span_own = aggregate_device_events(
                trace_dir)
    else:
        totals, n_events, span_us, span_own = aggregate_device_events(
            trace_dir)
    group_of = {name: classify(name) for name in totals}
    per_step = {k: v / args.steps for k, v in totals.items()}
    total_us = sum(per_step.values())
    groups = collections.Counter()
    for name, us in per_step.items():
        groups[group_of[name]] += us
    span_groups = {k: collections.Counter() for k in span_us}
    for k, names in span_own.items():
        for name, us in names.items():
            span_groups[k][group_of[name]] += us
    span_ms = {k: (inc / args.steps / 1e3,
                   sum(span_own[k].values()) / args.steps / 1e3)
               for k, inc in span_us.items()}

    print(f"\n== device time: {total_us / 1e3:.3f} ms/step over {n_events} "
          f"events ==")
    for label, us in groups.most_common():
        share = us / total_us * 100 if total_us else float("nan")
        print(f"  {label:<34} {us / 1e3:8.3f} ms  ({share:5.1f}%)")
    print("\n== device time by program span (ms/step): inclusive, self; "
          "the self time's largest groups ==")
    for name, (inc, own) in sorted(span_ms.items(), key=lambda kv: -kv[1][0]):
        top = span_groups[name].most_common(3)
        print(f"  {name:<20} {inc:8.3f} {own:8.3f}  " + ", ".join(
            f"{g} {us / args.steps / 1e3:.3f}" for g, us in top))
    print(f"\n== top {args.top} kernels (ms/step) ==")
    rows = sorted(per_step.items(), key=lambda kv: -kv[1])[:args.top]
    for name, us in rows:
        print(f"  {us / 1e3:8.3f}  [{group_of[name]}] {name[:100]}")

    result = {"metric": "train_step_device_time_by_group",
              "steps": args.steps, "events": n_events,
              "total_ms": total_us / 1e3,
              "profiler_device_ms": profiler_ms,
              "groups_ms": {k: v / 1e3 for k, v in groups.items()},
              "spans_ms": {k: {"inclusive": inc, "self": own}
                           for k, (inc, own) in span_ms.items()},
              "span_groups_ms": {k: {g: us / args.steps / 1e3
                                     for g, us in v.items()}
                                 for k, v in span_groups.items()},
              "ops_ms": {k: v / 1e3 for k, v in rows}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"\nwrote {args.json}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
