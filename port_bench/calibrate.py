"""Readings that the correctness limits are set from.

    python -m port_bench.calibrate --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

For every seed: set-up and a short window of the cell as a run makes
them, then the numbers compared between the program and the reference
(the lower readings).  For each control seed: the reference put in the
program's place and computed in the nearest precision below the
configuration's (fp8 operands for bf16, TF32 for float32), against the
reference (the upper readings).  For each fault seed (training cells):
the reference on half of each batch in the program's place, against the
reference on the whole batch.  One JSON line a seed; the cell's limits
are not applied.  Every seed runs in this one process, so the kernels
are built once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from port_bench import harness


def main(argv=None, root=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="",
                   help="training cells: half of each batch left out")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = root or os.path.dirname(harness.PACKAGE_DIR)
    cell = harness.load_cell(root, args.workload)

    import torch

    dev = torch.device(device or "cuda")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    control, fault = seeds(args.control_seeds), seeds(args.fault_seeds)
    every = list(dict.fromkeys(seeds(args.seeds) + control + fault))
    for seed in every:
        t0 = time.perf_counter()
        driver = harness.driver_class(cell)(cell, seed, dev,
                                            harness.Spans())
        driver.setup()
        driver.window(args.seconds)
        driver.free()
        kinds = [("program", driver.program_numbers)]
        if seed in control:
            kinds.append(("control", driver.control_numbers))
        if seed in fault:
            kinds.append(("half_batch", driver.fault_numbers))
        for kind, numbers in kinds:
            emit({"workload": cell.name, "seed": seed, "kind": kind,
                  "numbers": numbers(),
                  "seconds": time.perf_counter() - t0,
                  "device": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")})
        del driver
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
