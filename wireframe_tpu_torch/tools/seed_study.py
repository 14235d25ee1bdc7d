"""Multi-seed quality study: train + evaluate a recipe across seeds and
report mean ± std.

The port's copy of the repository's `tools/seed_study.py`: the same
records, crash-resume and summary.  Each seed runs in fresh subprocesses
of the port's CLIs, so the device behaviour matches a user's CLI run:
`python -m wireframe_tpu_torch.main`, then
`python -m wireframe_tpu_torch.evaluate --pipelined --eval-batch 8` per
checkpoint variant, and with `--decoded`
`python -m wireframe_tpu_torch.tools.calibrate_threshold`.  `--device`
is passed to every one of them (CUDA by default, as every port CLI; with
no GPU the study raises unless given `--device cpu`).

Results append to `<out>/results.jsonl`; re-running skips seeds that are
already recorded for the same tag, so a study split over several runs
(one seed per run, `--seeds 3`) resumes where it stopped.  Each record
also carries `"device"`: the card's name and power limit as `nvidia-smi`
gives them, or "cpu".

Two deliberate divergences from the repository's tool: the `device`
field, and the resume path's decoded re-evaluation is guarded like the
fresh path's (a failed calibration warns and the remaining seeds go on).

Usage:
  python -m wireframe_tpu_torch.tools.seed_study \\
      --config configs/recommended.yaml --data-root CORPUS \\
      --seeds 0,1,2,3,4 --tag recipe [--set train.ema_decay=0.999] \\
      [--eval-ema] [--decoded] [--keep-checkpoints] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

METRIC_LINES = {
    "wed": re.compile(r"Wireframe Edit distance\s+([-\d.eE]+)"),
    "aco": re.compile(r"Average Corner offset\s+([-\d.eE]+)"),
    "corner_p": re.compile(r"Corners Precision:\s+([-\d.eE]+)"),
    "corner_r": re.compile(r"Corners Recall:\s+([-\d.eE]+)"),
    "corner_f1": re.compile(r"Corners F1:\s*([-\d.eE]+)"),
    "edge_p": re.compile(r"Edges Precision:\s+([-\d.eE]+)"),
    "edge_r": re.compile(r"Edges Recall:\s+([-\d.eE]+)"),
    "edge_f1": re.compile(r"Edges F1:\s+([-\d.eE]+)"),
}


def parse_metrics(text: str) -> dict:
    out = {}
    for k, pat in METRIC_LINES.items():
        m = pat.search(text)
        if m:
            out[k] = float(m.group(1))
    return out


def run(cmd, log_path):
    t0 = time.time()
    with open(log_path, "w") as f:
        proc = subprocess.run(cmd, cwd=REPO, stdout=f,
                              stderr=subprocess.STDOUT)
    dt = time.time() - t0
    with open(log_path) as f:
        text = f.read()
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd)} failed rc={proc.returncode}:\n{text[-2000:]}")
    return text, dt


def _cli(module, args):
    """`python -m <module>` with the study's device."""
    cmd = [sys.executable, "-m", module]
    if args.device:
        cmd += ["--device", args.device]
    return cmd


# evaluate_model key -> study short name (the decoded path reads the
# calibrator's JSON instead of scraping the evaluate CLI's stdout).
_METRIC_KEYS = {
    "average_wed": "wed", "average_corner_offset": "aco",
    "corners_precision": "corner_p", "corners_recall": "corner_r",
    "corners_f1": "corner_f1", "edges_precision": "edge_p",
    "edges_recall": "edge_r", "edges_f1": "edge_f1",
}


def _append(results_path, rec):
    with open(results_path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _eval_decoded(args, seed, ckdir, results_path, train_s):
    """Decoded-corners protocol: jointly calibrate the vertex-existence
    and edge-confidence thresholds on the TRAIN split with
    `eval.live_corner_filter=true`, then record the test metrics as
    variant "decoded".  The sweep grids are the repository tool's reduced
    ones (4 vertex x 4 edge values)."""
    json_path = os.path.join(args.out, f"{args.tag}_s{seed}_decoded.json")
    cmd = _cli("wireframe_tpu_torch.tools.calibrate_threshold", args) + [
        "--checkpoint-dir", ckdir, "--data-root", args.data_root,
        "--param", "joint",
        "--vertex-thresholds", "0.2,0.3,0.5,0.7",
        "--thresholds", "0.2,0.3,0.4,0.5",
        "--set", "eval.live_corner_filter=true",
        "--json-out", json_path]
    if args.config:
        cmd += ["--config", args.config]
    for ov in args.overrides:
        cmd += ["--set", ov]
    _, cal_s = run(cmd, os.path.join(
        args.out, f"{args.tag}_s{seed}_decoded_cal.log"))
    with open(json_path) as f:
        cal = json.load(f)
    m = {short: cal["test_metrics"][k]
         for k, short in _METRIC_KEYS.items() if k in cal["test_metrics"]}
    rec = {"tag": args.tag, "seed": seed, "variant": "decoded",
           "train_s": round(train_s, 1), "eval_s": round(cal_s, 1),
           "vertex_thresh": cal["vertex_existence_thresh"],
           "edge_thresh": cal["edge_confidence_thresh"], **m,
           "device": args.device_line}
    _append(results_path, rec)
    print(f"[seed_study] {args.tag} seed {seed} [decoded @ "
          f"v={cal['vertex_existence_thresh']} "
          f"e={cal['edge_confidence_thresh']}]: "
          f"C-F1 {m.get('corner_f1'):.3f} E-F1 {m.get('edge_f1'):.3f} "
          f"WED {m.get('wed'):.3f} ACO {m.get('aco'):.3f}", flush=True)


def _try_eval_decoded(args, seed, ckdir, results_path, train_s):
    """`_eval_decoded`, non-fatal: a calibration failure must not kill a
    multi-seed study whose train + eval records are already good; a
    later run re-attempts the missing decoded record."""
    try:
        _eval_decoded(args, seed, ckdir, results_path, train_s)
    except Exception as e:  # noqa: BLE001
        print(f"[seed_study] WARNING: decoded eval failed for "
              f"{args.tag} seed {seed}: {e}", flush=True)


def _eval_variants(args, seed, variants, results_path, train_s):
    """Evaluate checkpoint variants and append records to results.jsonl.

    The study's `--set` overrides are forwarded to the evaluate CLI too:
    model-scoped keys round-trip through checkpoint metadata anyway, but
    data/eval-scoped keys (e.g. `eval.edge_confidence_thresh`) stay
    CLI-controlled; dropping them would record metrics for another
    configuration than the one studied.
    """
    for variant, vdir in variants:
        eval_cmd = _cli("wireframe_tpu_torch.evaluate", args) + [
            "--config", args.config, "--data-root", args.data_root,
            "--checkpoint-dir", vdir, "--pipelined", "--eval-batch", "8"]
        for ov in args.overrides:
            eval_cmd += ["--set", ov]
        text, eval_s = run(eval_cmd, os.path.join(
            args.out, f"{args.tag}_s{seed}_{variant}_eval.log"))
        m = parse_metrics(text)
        if "edge_f1" not in m:
            raise RuntimeError(
                f"no metrics parsed from eval output:\n{text[-2000:]}")
        rec = {"tag": args.tag, "seed": seed, "variant": variant,
               "train_s": round(train_s, 1), "eval_s": round(eval_s, 1),
               **m, "device": args.device_line}
        _append(results_path, rec)
        print(f"[seed_study] {args.tag} seed {seed} [{variant}]: "
              f"E-F1 {m.get('edge_f1'):.3f} WED {m.get('wed'):.3f} "
              f"C-F1 {m.get('corner_f1'):.3f} ACO {m.get('aco'):.3f}",
              flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config",
                   default=os.path.join(REPO, "configs", "recommended.yaml"))
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--seeds", default="0,1,2,3,4")
    p.add_argument("--tag", default="recipe")
    p.add_argument("--out", default=os.path.join(REPO, "build",
                                                 "seed_study"))
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--eval-ema", action="store_true",
                   help="also evaluate the <ckdir>/ema checkpoint")
    p.add_argument("--decoded", action="store_true",
                   help="also record the decoded-corners protocol "
                        "(train-split joint threshold calibration + "
                        "live_corner_filter test eval) as variant "
                        "'decoded'")
    p.add_argument("--keep-checkpoints", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu, passed to every CLI")
    args = p.parse_args(argv)
    # The CLIs run from the repository root: paths are made absolute
    # against the caller's working directory first.
    for key in ("config", "data_root", "out"):
        setattr(args, key, os.path.abspath(getattr(args, key)))
    return args


def main(argv=None):
    args = parse_args(argv)
    from wireframe_tpu_torch.utils.platform import card_line, resolve_device

    args.device_line = card_line(resolve_device(args.device))

    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out, "results.jsonl")
    done = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            for line in f:
                r = json.loads(line)
                done[(r["tag"], r["seed"], r.get("variant", "final"))] = r

    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        ckdir = os.path.join(args.out, f"{args.tag}_s{seed}")
        if (args.tag, seed, "final") in done:
            # Crash-resume: the final variant is recorded.  A missing ema
            # or decoded record is made now when the checkpoint survived
            # (--keep-checkpoints), else warned about: a silent skip would
            # average that summary over fewer seeds than the final one.
            train_s = done[(args.tag, seed, "final")]["train_s"]
            if args.eval_ema and (args.tag, seed, "ema") not in done:
                ema_dir = os.path.join(ckdir, "ema")
                if os.path.isdir(ema_dir):
                    _eval_variants(args, seed, [("ema", ema_dir)],
                                   results_path, train_s=train_s)
                else:
                    print(f"[seed_study] WARNING: {args.tag} seed {seed} "
                          f"has no ema record and its checkpoint was "
                          f"deleted — the ema summary will cover fewer "
                          f"seeds (rerun this seed or use "
                          f"--keep-checkpoints)", flush=True)
            else:
                print(f"[seed_study] {args.tag} seed {seed}: already "
                      f"recorded")
            if args.decoded and (args.tag, seed, "decoded") not in done:
                if os.path.isdir(ckdir):
                    _try_eval_decoded(args, seed, ckdir, results_path,
                                      train_s=train_s)
                else:
                    print(f"[seed_study] WARNING: {args.tag} seed {seed} "
                          f"has no decoded record and its checkpoint was "
                          f"deleted — rerun this seed or use "
                          f"--keep-checkpoints", flush=True)
            continue
        train_cmd = _cli("wireframe_tpu_torch.main", args) + [
            "--config", args.config, "--data-root", args.data_root,
            "--checkpoint-dir", ckdir, "--set", f"train.seed={seed}"]
        for ov in args.overrides:
            train_cmd += ["--set", ov]
        print(f"[seed_study] {args.tag} seed {seed}: training...",
              flush=True)
        _, train_s = run(train_cmd, os.path.join(
            args.out, f"{args.tag}_s{seed}_train.log"))

        variants = [("final", ckdir)]
        if args.eval_ema and os.path.isdir(os.path.join(ckdir, "ema")):
            variants.append(("ema", os.path.join(ckdir, "ema")))
        _eval_variants(args, seed, variants, results_path, train_s)
        if args.decoded:
            _try_eval_decoded(args, seed, ckdir, results_path, train_s)
        if not args.keep_checkpoints:
            import shutil

            shutil.rmtree(ckdir, ignore_errors=True)

    # Summary over everything recorded for this tag.
    with open(results_path) as f:
        rows = [json.loads(line) for line in f]
    for variant in sorted({r.get("variant", "final") for r in rows
                           if r["tag"] == args.tag}):
        sel = [r for r in rows
               if r["tag"] == args.tag and r.get("variant") == variant]
        if not sel:
            continue
        print(f"\n== {args.tag} [{variant}] over {len(sel)} seeds ==")
        for k in ("edge_f1", "wed", "corner_f1", "corner_p", "aco"):
            vals = [r[k] for r in sel if k in r]
            if len(vals) >= 2:
                print(f"  {k}: mean {statistics.mean(vals):.4f} "
                      f"± {statistics.stdev(vals):.4f} "
                      f"(min {min(vals):.3f} max {max(vals):.3f})")
            elif vals:
                print(f"  {k}: {vals[0]:.4f} (n=1)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
