"""Corpus-scale eval proof: sharded == plain, and clouds per second.

The port's copy of `tools/scale_eval.py`, with its flags and report keys
plus `--device`: (1) generate an N-building corpus (the port's
`tools.gen_demo_data`), (2) run the sharded eval path
(`eval.distributed.evaluate_model_sharded`, device Hausdorff) over it,
(3) run the plain unsharded path, (4) check that the merged metrics are
IDENTICAL and (5) report eval throughput (buildings/sec) of both.

The port's merge adds every sample's counters in dataset-index order
(eval/distributed.py), so the check is exact equality of every metric,
where the repository's tool allows 1e-9 relative on the float ones.
Both paths share one eval step and are warmed before the timers; the
dataset's parse cache is filled first and its time reported on its own
(`parse_s`); rep 0 absorbs the remaining first-pass costs and the LAST
rep is the headline.

Runs on CUDA; `--device cpu` runs on the CPU.

Usage:
  python -m wireframe_tpu_torch.tools.scale_eval --checkpoint-dir ck \\
      [--n 500] [--shards 8] [--corpus build/corpus_scale] [--json OUT] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--n", type=int, default=500)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--corpus", default="build/corpus_scale")
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--json", default=None, help="write the report here too")
    p.add_argument("--skip-unsharded", action="store_true",
                   help="only run + time the sharded path")
    p.add_argument("--legacy", action="store_true",
                   help="use the small-batch eval path (evaluate_model per "
                        "shard) instead of the fused pipeline "
                        "(eval/pipeline.py)")
    p.add_argument("--eval-batch", type=int, default=64,
                   help="device batch for the fused pipeline")
    p.add_argument("--reps", type=int, default=2,
                   help="timed passes per path; rep 0 absorbs first-pass "
                        "costs, the LAST rep is the headline (both paths "
                        "warm)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import os
    import shutil

    import torch

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import Building3DDataset
    from wireframe_tpu_torch.eval.distributed import evaluate_model_sharded
    from wireframe_tpu_torch.eval.evaluator import build_model, evaluate_model
    from wireframe_tpu_torch.eval.pipeline import (
        evaluate_corpus_pipelined,
        make_eval_step,
    )
    from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main
    from wireframe_tpu_torch.train.checkpoint import (
        apply_checkpoint_model_config,
        load_checkpoint,
    )
    from wireframe_tpu_torch.utils.platform import card_line, resolve_device

    dev = resolve_device(args.device)
    test_dir = os.path.join(args.corpus, "test", "xyz")
    have = len(os.listdir(test_dir)) if os.path.isdir(test_dir) else 0
    if have != args.n:
        print(f"generating {args.n}-building corpus at {args.corpus} "
              f"(found {have})", file=sys.stderr, flush=True)
        shutil.rmtree(args.corpus, ignore_errors=True)
        gen_main(["--out", args.corpus, "--train", "1",
                  "--test", str(args.n)])

    cfg = load_config(args.config, args.overrides)
    cfg.data.root_dir = args.corpus
    payload, meta = load_checkpoint(args.checkpoint_dir)
    apply_checkpoint_model_config(cfg, meta)
    params = payload["params"]
    dataset = Building3DDataset(cfg.data, "test")
    print(f"evaluating {len(dataset)} buildings "
          f"({args.shards} shards, device Hausdorff)",
          file=sys.stderr, flush=True)

    pipe_kw = {"batch": args.eval_batch}
    if not args.legacy:
        # One eval step for the sharded AND plain runs, warmed before
        # either timer starts.
        pipe_kw["eval_step"] = make_eval_step(cfg, 128, 64, args.eval_batch)
        warm_clouds = torch.zeros(
            (args.eval_batch, cfg.data.num_points, cfg.model.input_dim),
            device=dev)
        warm_gt = torch.zeros((args.eval_batch, 64, 2, 3), device=dev)
        out = pipe_kw["eval_step"](build_model(cfg, params, dev),
                                   warm_clouds, warm_gt)
        out["dist"].cpu()
    # Fill the dataset's parse cache before EITHER timer: otherwise the
    # first path pays every cold .xyz / .obj parse.
    t0 = time.perf_counter()
    for i in range(len(dataset)):
        dataset.load_raw(i)
    t_parse = time.perf_counter() - t0

    def run_sharded():
        t0 = time.perf_counter()
        out = evaluate_model_sharded(cfg, params, dataset,
                                     n_shards=args.shards,
                                     device_hausdorff=True,
                                     pipelined=not args.legacy,
                                     pipeline_kwargs=pipe_kw, device=dev)
        return out, time.perf_counter() - t0

    q_overflows = None

    def run_plain():
        nonlocal q_overflows
        t0 = time.perf_counter()
        if args.legacy:
            out = evaluate_model(cfg, params, dataset, verbose=False,
                                 device_hausdorff=True, device=dev)
        else:
            stats = {}
            out = evaluate_corpus_pipelined(cfg, params, dataset,
                                            stats=stats, device=dev,
                                            **pipe_kw)
            q_overflows = stats["qmax_overflows"]
        return out, time.perf_counter() - t0

    sharded_s, plain_s = [], []
    for _ in range(max(1, args.reps)):
        sharded, t = run_sharded()
        sharded_s.append(t)
        if not args.skip_unsharded:
            plain, t = run_plain()
            plain_s.append(t)

    report = {
        "n_buildings": len(dataset),
        "shards": args.shards,
        "pipelined": not args.legacy,
        "device": card_line(dev),
        "parse_s": round(t_parse, 1),
        "reps_sharded_s": [round(t, 1) for t in sharded_s],
        "sharded_s": round(sharded_s[-1], 1),
        "sharded_buildings_per_sec": round(len(dataset) / sharded_s[-1], 2),
        "metrics": {k: round(v, 6) for k, v in sharded.items()},
    }
    if q_overflows is not None:
        report["qmax_overflows"] = q_overflows

    if not args.skip_unsharded:
        report["reps_unsharded_s"] = [round(t, 1) for t in plain_s]
        report["unsharded_s"] = round(plain_s[-1], 1)
        report["unsharded_buildings_per_sec"] = round(
            len(dataset) / plain_s[-1], 2)
        mismatch = {k: (sharded[k], plain[k]) for k in sharded
                    if sharded[k] != plain[k]}
        report["sharded_equals_unsharded"] = not mismatch
        if mismatch:
            report["mismatch"] = {k: list(v) for k, v in mismatch.items()}
            print(f"MISMATCH: {mismatch}", file=sys.stderr)

    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return 0 if report.get("sharded_equals_unsharded", True) else 1


if __name__ == "__main__":
    sys.exit(main())
