"""Serving-latency sweep: true p50/p90/p99 per request batch across the
point-bucket grid, on one GPU.

Port of the repository's `tools/bench_latency.py`.  Each (batch, bucket)
cell times individually dispatched forwards (`train.step.make_forward_fn`)
with a data-dependent host read-back per iteration: the latency a serving
client observes.  Pipelined throughput is `wireframe_tpu_torch.bench`'s.

Writes the grid as markdown to `--out` (default `build/bench/latency.md`
under the repository root, which git ignores; the repository's
`BENCH_LATENCY.md` is a TPU record and is never written) and prints one
JSON line with the grid, last on stdout.

`--probe BUCKET,BATCH` skips the grid and runs `--probe-iters` round trips
at one cell, recording per trip the dispatch (host time until the forward
returns, the card still working) against the read-back (until the result
is on the host), and appends the split and the outliers above 3x the
median to `--out`.

Usage (CUDA; `--device cpu` runs the plain versions on the CPU, and
without a GPU and without it the tool raises):
  python -m wireframe_tpu_torch.tools.bench_latency [--batches 1,8,32,128]
      [--buckets 2048,4096,8192,16384] [--iters 30] [--dtype bfloat16]
      [--config configs/recommended.yaml] [--set k.e.y=v ...]
      [--out build/bench/latency.md] [--probe 16384,8] [--device cpu]

Without --config/--set the grid measures the reference-parity `Config()`;
--dtype and --pallas apply on top of either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from wireframe_tpu_torch.utils.profiling import (
    log,
    round_trips,
    staged_clouds,
)

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--batches", default="1,8,32,128")
    p.add_argument("--buckets", default="2048,4096,8192,16384")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--pallas", default="1")
    p.add_argument("--config", default=None,
                   help="optional config yaml (e.g. configs/recommended.yaml)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="k.e.y=v", help="config overrides")
    p.add_argument("--out", default=str(REPO / "build" / "bench"
                                        / "latency.md"))
    p.add_argument("--probe", default=None, metavar="BUCKET,BATCH",
                   help="skip the grid: --probe-iters round trips at one "
                        "cell, dispatch against read-back per trip")
    p.add_argument("--probe-iters", type=int, default=120)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.train.loop import init_model
    from wireframe_tpu_torch.train.step import make_forward_fn
    from wireframe_tpu_torch.utils.platform import card_line, resolve_device

    dev = resolve_device(args.device)
    batches = [int(x) for x in args.batches.split(",")]
    buckets = [int(x) for x in args.buckets.split(",")]
    cfg = load_config(args.config, args.overrides)
    cfg.model.compute_dtype = args.dtype
    cfg.model.use_pallas_encoder = args.pallas == "1"
    cfg.__post_init__()
    card = card_line(dev)
    log("lat", f"device {card}; init params")
    model = init_model(cfg, dev, seed=0)
    fwd = make_forward_fn(cfg)
    r = np.random.default_rng(0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def inputs(b, bucket):
        # Distinct pre-staged inputs: consecutive trips read other clouds.
        return staged_clouds(r, b, bucket, cfg.model.input_dim, 4, dev)

    def read_back(o):
        return float(o["vertices"].float().mean() + o["edge_probs"].mean())

    if args.probe:
        bucket, b = (int(t) for t in args.probe.split(","))
        if args.probe_iters < 2:
            raise SystemExit("--probe-iters must be >= 2 (trimmed "
                             "percentiles need at least one survivor)")
        xs = inputs(b, bucket)
        log("lat", f"probe {bucket}x{b}: {args.probe_iters} trips")
        for i in range(3):      # untimed warmup
            read_back(fwd(model, xs[i % len(xs)]))
        recs = []
        for i in range(args.probe_iters):
            t0 = time.perf_counter()
            o = fwd(model, xs[i % len(xs)])
            t1 = time.perf_counter()      # the host queued the forward
            read_back(o)
            t2 = time.perf_counter()      # the result is on the host
            recs.append((t1 - t0, t2 - t1, t2 - t0))
        disp, read, total = (np.array(x) * 1e3 for x in zip(*recs))
        med = float(np.median(total))
        out_idx = [int(i) for i in np.nonzero(total > 3 * med)[0]]
        n_trim = min(max(1, int(np.ceil(len(total) * 0.01))),
                     len(total) - 1)
        trimmed = np.sort(total)[:-n_trim]
        report = {
            "metric": "serving_latency_probe", "device": card,
            "bucket": bucket, "batch": b, "iters": len(total),
            "p50_ms": float(np.percentile(total, 50)),
            "p90_ms": float(np.percentile(total, 90)),
            "p99_ms": float(np.percentile(total, 99)),
            "p99_trimmed_ms": float(np.percentile(trimmed, 99)),
            "max_ms": float(total.max()), "trim_top_n": n_trim,
            "dispatch_p50_ms": float(np.percentile(disp, 50)),
            "readback_p50_ms": float(np.percentile(read, 50)),
            "outliers_gt_3x_median": [
                {"trip": i, "total_ms": float(total[i]),
                 "dispatch_ms": float(disp[i]),
                 "readback_ms": float(read[i])} for i in out_idx],
        }
        with open(args.out, "a") as f:
            f.write(
                f"\n## Outlier probe — {bucket} pts x batch {b} "
                f"({len(total)} trips, {card})\n\n"
                f"p50 {report['p50_ms']:.3f} ms | p90 {report['p90_ms']:.3f}"
                f" | p99 {report['p99_ms']:.3f} | trimmed-p99 (drop top "
                f"{n_trim}) {report['p99_trimmed_ms']:.3f} | max "
                f"{report['max_ms']:.3f}.  Median split: dispatch "
                f"{report['dispatch_p50_ms']:.3f} ms, read-back "
                f"{report['readback_p50_ms']:.3f} ms.  Outliers >3x median: "
                f"{len(out_idx)}"
                + ("".join(f"; trip {o['trip']}: {o['total_ms']:.1f} ms "
                           f"(dispatch {o['dispatch_ms']:.1f}, read-back "
                           f"{o['readback_ms']:.1f})"
                           for o in report["outliers_gt_3x_median"]))
                + "\n")
        log("lat", f"probe appended to {args.out}")
        print(json.dumps(report), flush=True)
        return 0

    grid = {}
    for bucket in buckets:
        for b in batches:
            xs = inputs(b, bucket)
            log("lat", f"bucket {bucket} batch {b}: {args.iters} trips")
            s = round_trips(lambda i: read_back(fwd(model, xs[i % len(xs)])),
                            args.iters, items_per_step=b)
            grid[f"{bucket}x{b}"] = {
                "bucket": bucket, "batch": b,
                "p50_ms": s["p50_s"] * 1e3, "p90_ms": s["p90_s"] * 1e3,
                "p99_ms": s["p99_s"] * 1e3,
                "per_cloud_p50_ms": s["p50_s"] * 1e3 / b,
                "round_trip_clouds_per_sec": s["items_per_sec"]}

    md = [
        "# Serving latency grid (PyTorch/CUDA port)",
        "",
        f"Measured on `{card}` ({args.dtype}"
        f"{', fused encoder kernel K1' if cfg.model.use_pallas_encoder else ''}"
        f"), `vertex_head={cfg.model.vertex_head}` "
        f"(decoder_kv_pool={cfg.model.decoder_kv_pool}), "
        f"{cfg.data.max_vertices} vertex slots, random weights.  Each cell: "
        f"{args.iters} individually timed dispatch -> host read-back round "
        "trips of `make_forward_fn` at a fixed (batch, bucket) shape "
        "(pipelined throughput is `python -m wireframe_tpu_torch.bench`'s).",
        "",
        "| points bucket | batch | p50 ms | p90 ms | p99 ms | "
        "per-cloud p50 ms | round-trip clouds/s |",
        "|---|---|---|---|---|---|---|",
    ]
    for bucket in buckets:
        for b in batches:
            g = grid[f"{bucket}x{b}"]
            md.append(
                f"| {bucket} | {b} | {g['p50_ms']:.3f} | {g['p90_ms']:.3f} | "
                f"{g['p99_ms']:.3f} | {g['per_cloud_p50_ms']:.4f} | "
                f"{g['round_trip_clouds_per_sec']:.1f} |")
    md += ["", "Regenerate: `python -m wireframe_tpu_torch.tools."
           "bench_latency`.", ""]
    with open(args.out, "w") as f:
        f.write("\n".join(md))
    log("lat", f"wrote {args.out}")
    print(json.dumps({"metric": "serving_latency_grid", "device": card,
                      "dtype": args.dtype, "iters": args.iters,
                      "grid": grid}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
