"""Cold-start report of the port, on one GPU.

Port of the repository's `tools/compile_report.py`.  The JAX package
pays its cold start in tracing and XLA / Mosaic compiles; the port runs
eager PyTorch, which traces and compiles nothing, and pays it in two
other places, each reported by name:
  - `build_s`: each kernel library's `nvcc` build (`ops/_build.py`), all
    started together, into a FRESH build directory (default a temporary
    one under `build/cold/` in the repository root, removed when the
    report ends; a directory named with `--build-dir` is kept, and one
    with built libraries in it measures the warm path);
  - `init_s`: the model's weights, made on the host from a seed and
    moved to the card (the CUDA context is made here);
  - `first_exec_s`: the first call of each program the CLIs run (the
    train step, the forward at batch 128, the forward at batch 8 per
    point bucket, K4 alone), up to its result on the host: cuBLAS
    set-up, the kernels' first launches, the allocator's first blocks.
    `second_exec_s`, the next call, is the steady cost beside it.
Run it as its own process: a process loads each kernel library once, so
in a process that already ran a kernel nothing is cold.  Prints one JSON
line, last on stdout.

Usage (CUDA; `--device cpu` skips the builds, which the CPU does not
use, and times the programs on the CPU; without a GPU and without it the
tool raises):
  python -m wireframe_tpu_torch.tools.compile_report
      [--programs train,fwd128,fwd_bucket,lsa] [--build-dir DIR]
      [--batch 64] [--points 2560] [--config configs/recommended.yaml]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from wireframe_tpu_torch.config import RECIPE_YAML
from wireframe_tpu_torch.utils.profiling import staged_clouds

REPO = Path(__file__).resolve().parents[2]
LIBRARIES = ("fused_encoder", "chain_grad", "lockstep_lsa", "layernorm_rows")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--programs", default="train,fwd128,fwd_bucket,lsa")
    p.add_argument("--build-dir", default=None,
                   help="kernel build directory, kept (default: a fresh "
                        "temporary one under build/cold/, so every library "
                        "is built, removed at the end)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--points", type=int, default=2560)
    p.add_argument("--config", default=str(RECIPE_YAML))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from wireframe_tpu_torch.utils.platform import card_line, resolve_device

    dev = resolve_device(args.device)
    if not os.path.exists(args.config):
        p.error(f"config not found: {args.config}")
    report = {"device": card_line(dev), "build_dir": None, "builds": {},
              "build_wall_s": None, "programs": {}}
    with contextlib.ExitStack() as cleanup:
        if dev.type == "cuda":
            build_dir = args.build_dir
            if build_dir is None:
                cold = REPO / "build" / "cold"
                cold.mkdir(parents=True, exist_ok=True)
                build_dir = cleanup.enter_context(
                    tempfile.TemporaryDirectory(dir=cold))
            _build_libraries(Path(build_dir), report)
        _run_programs(args, dev, report)
    print(json.dumps(report), flush=True)
    return 0


def _build_libraries(build_dir: Path, report: dict) -> None:
    """nvcc every library into build_dir, all together, and load each:
    the process's kernels then come from there."""
    from wireframe_tpu_torch.ops import _build

    built, wall = _timed(lambda: _build.build_all(LIBRARIES, build_dir))
    for name in LIBRARIES:
        path, secs, _ = built[name]
        _build.load(name, build_dir)
        report["builds"][name] = {"library": path.name, "build_s": secs}
        print(f"build {name:14s} {secs:7.2f}s  {path.name}",
              file=sys.stderr, flush=True)
    report["build_dir"] = str(build_dir)
    report["build_wall_s"] = wall


def _run_programs(args, dev, report: dict) -> None:
    """The first and second call of each program in args.programs."""

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.ops.lockstep_lsa import solve_lsa_rows
    from wireframe_tpu_torch.train.loop import device_batch, init_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import (
        make_forward_fn,
        make_train_step,
    )
    from wireframe_tpu_torch.utils.synth import make_random_batch

    cfg = load_config(args.config)
    cfg.data.num_points = args.points
    cfg.train.device_augment = False
    cfg.__post_init__()
    b, n, d, v = args.batch, args.points, cfg.model.input_dim, \
        cfg.model.max_vertices
    r = np.random.default_rng(0)
    model, init_s = _timed(lambda: init_model(cfg, dev, seed=0))
    report["init_s"] = init_s

    def measure(name, call):
        """call() -> a 0-d device tensor; its float() is the read-back."""
        _, first = _timed(lambda: float(call()))
        _, second = _timed(lambda: float(call()))
        report["programs"][name] = {"first_exec_s": first,
                                    "second_exec_s": second}
        print(f"{name:24s} first-exec {first:7.3f}s  second {second:7.3f}s",
              file=sys.stderr, flush=True)

    want = set(args.programs.split(","))
    if "train" in want:
        state = create_train_state(cfg, model)
        step = make_train_step(cfg)
        batch = device_batch(make_random_batch(cfg, b), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        measure(f"train_step_B{b}",
                lambda: step(state, batch, gen)[1]["total_loss"])

    fwd = make_forward_fn(cfg)

    def forward_program(bs, n_pts):
        x, = staged_clouds(r, bs, n_pts, d, 1, dev)
        return lambda: fwd(model, x)["vertices"].float().mean()

    if "fwd128" in want:
        measure("forward_B128", forward_program(128, n))
    if "fwd_bucket" in want:
        for bucket in cfg.data.point_buckets:
            measure(f"forward_B8_{bucket}", forward_program(8, bucket))
    if "lsa" in want:
        cost = torch.from_numpy(r.random((b, v, v)).astype(np.float32)
                                ).to(dev)
        counts = torch.from_numpy(r.integers(4, v + 1, size=b)
                                  .astype(np.int32)).to(dev)
        measure(f"lsa_B{b}",
                lambda: solve_lsa_rows(cost, counts).sum().float())


if __name__ == "__main__":
    sys.exit(main())
