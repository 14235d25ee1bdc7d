"""One run of one cell of the port's benchmark.

    python -m port_bench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights and traffic from the seed, the program built and every
shape the cell uses warmed up), then a window of `--seconds` in which the
cell's driver drives the program, then (`--trace 1`) a short profiled
segment of a fixed amount of work, then the check of what the timed path
produced against the plain reference in `port_bench/reference/`.

The last line on stdout is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`: each number compared with its limit, which also close stderr.

Exits non-zero and prints no result without CUDA or with fewer cards than
the cell asks for, and when JAX, flax or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

from port_bench import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "wireframe_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (`wireframe_tpu_torch` is not
    `wireframe_tpu`)."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m port_bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _number(x: float) -> float:
    if not math.isfinite(x):
        raise ValueError(f"a metric read {x}")
    return float(x)


def main(argv: Optional[Sequence[str]] = None, root: Optional[str] = None,
         device: Optional[str] = None, t0: Optional[float] = None) -> int:
    """Run one cell.  `device` ("cpu" in the CPU tests) skips the look for
    a card; `root` is the checkout (default: this package's parent)."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = root or os.path.dirname(harness.PACKAGE_DIR)
    cell = harness.load_cell(root, args.workload)

    import torch

    if device is None:
        need = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"port_bench: the cell needs {need} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    spans = harness.Spans()
    driver = harness.driver_class(cell)(cell, args.seed, dev, spans)

    driver.setup()
    setup_s = time.perf_counter() - t0
    values, window = driver.window(args.seconds)
    segment = None
    if args.trace:
        from port_bench import trace

        segments: List = []
        spans.profiling = True
        with trace.profiled(segments):
            driver.segment()
        spans.profiling = False
        segment = segments[0]
    memory_peak = driver.memory_peak()
    device_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    reading = harness.Reading(cell=cell, device_name=device_name,
                              window=window, spans=spans, segment=segment)
    readers = {m["name"]: harness.metric_module(root, m["name"])
               for m in cell.per_layer} if args.trace else {}
    metrics: Dict[str, Dict] = {}
    if args.trace:
        for m in cell.per_layer:
            value = readers[m["name"]].read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": _number(value),
                                      "unit": m["unit"]}
    else:
        values = dict(values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": _number(values[m["name"]]),
                                  "unit": m["unit"]}
    if cell.model["compute_dtype"] == "float32":
        for name, m in metrics.items():
            if "roofline" in name or "mfu" in name:
                print(f"port_bench: {name} against 3xTF32 (a third of the "
                      f"TF32 peak): {3 * m['value']!r} %", file=sys.stderr)
    for line in driver.notes():
        print(f"port_bench: {line}", file=sys.stderr)
    driver.free()
    checks = driver.check()
    spans.dump()

    leaked = forbidden_modules()
    if leaked:
        print("port_bench: modules of JAX or the JAX package were loaded: "
              + ", ".join(leaked), file=sys.stderr)
        return 4

    attempted, failed = window["attempted"], window["failed"]
    correct = failed == 0 and attempted > 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": device_name,
                         "count": 1,
                         "memory_peak_bytes": int(memory_peak)}}
    if segment is not None:
        from port_bench import trace

        claimed = [k for r in readers.values()
                   for k in getattr(r, "KERNELS", ())]
        result["device"]["busy_s"] = segment.busy()
        result["device"]["window_s"] = segment.wall
        result["breakdown"] = trace.breakdown(segment, claimed)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
