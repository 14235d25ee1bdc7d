"""A copy of the benchmark in a temporary root with its cells cut to a
size the CPU runs in seconds (narrow widths, 128 points, batch 4), and
limits for that size."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SMALL = {"model": {"encoder_hidden_dims": [32, 64], "encoder_output_dim": 32,
                   "decoder_dim": 32, "decoder_layers": 2,
                   "decoder_heads": 4, "decoder_ffn_dim": 64,
                   "edge_hidden_dim": 32, "edge_num_heads": 4,
                   "pallas_tile": 32, "pallas_chain_tile": 32},
         "data": {"num_points": 128, "point_buckets": [128, 256]}}

# Limits for the cut cells on the CPU, between the readings of sound runs
# of the program there and those of its control and of the faults the
# tests plant.  The float32 cell's later steps carry Adam's full-size
# steps of near-zero gradients (lr 1e-3), so only its first step is held
# tightly; its TF32 control does nothing on the CPU.
LIMITS = {
    "bfloat16 train": {"loss_gap": 0.008, "loss1_gap": 0.008,
                       "grad_gap": 0.5, "grad_gap_median": 0.01,
                       "change_gap": 0.5, "change_gap_median": 0.05,
                       "ema_gap": 0.9, "vertex1_gap": 0.02,
                       "exist1_gap": 0.02, "edge1_gap": 0.02},
    "float32 train": {"loss_gap": 0.5, "loss1_gap": 0.02, "free1_gap": 0.02,
                      "grad_gap": 0.5, "grad_gap_median": 0.05,
                      "change_gap": 0.5, "change_gap_median": 0.05,
                      "vertex1_gap": 1e-4, "exist1_gap": 1e-4,
                      "edge1_gap": 1e-4},
    "forward": {"vertex_gap": 0.02, "exist_gap": 0.02, "edge_gap": 0.02,
                "count_self_gap": 0.0, "decode_gap": 0.0},
}


# Cells whose files are in port_bench/ but whose host-clock spread on the
# card's host no bound of at most 0.25 holds (PERF.md, Open questions):
# the tests run them too, with the entries BENCHMARK.json would take.
OPEN_CELLS = [
    {"name": "recipe-train-b8", "config": "recipe", "traffic": "train-b8",
     "chips": 1, "why": "the shipped batch 8: the host sets the pace"},
    {"name": "recipe-serve-c1", "config": "recipe", "traffic": "serve-c1",
     "chips": 1, "why": "one client, one raw cloud a request"},
]


def add_open_cells(bench: dict) -> None:
    bench["workloads"] += OPEN_CELLS
    bench["end_to_end"].append({
        "name": "serve_p95_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["recipe-serve-c1"]})
    bench["per_layer"].append({
        "name": "idle_pct.serve", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "serve_p95_ms", "workloads": ["recipe-serve-c1"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "parity-train-b128" in m.get("workloads", []):
            m["workloads"].append("recipe-train-b8")


def make_root(dest: str) -> str:
    """dest/BENCHMARK.json and dest/port_bench/ with every cell cut, the
    open cells added."""
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    os.path.join(dest, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    add_open_cells(bench)
    for c in bench["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as f:
            conf = json.load(f)
        for sec, kv in SMALL.items():
            conf[sec].update(kv)
        with open(path, "w") as f:
            json.dump(conf, f)
    tdir = os.path.join(dest, "port_bench", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            t = json.load(f)
        for key, most in (("batch", 4), ("pool", 3), ("traced_steps", 1),
                          ("traced_calls", 1), ("checked_calls", 2),
                          ("in_flight", 2)):
            if key in t:
                t[key] = min(t[key], most)
        if t["driver"] == "serve":
            t.update(clouds=6, min_points=60, max_points=400,
                     warm_requests_per_bucket=1, checked_requests=4,
                     traced_requests=2)
        with open(path, "w") as f:
            json.dump(t, f)
    dtypes = {}
    for c in bench["configs"]:
        with open(os.path.join(dest, c["file"])) as f:
            dtypes[c["name"]] = json.load(f)["model"]["compute_dtype"]
    for w in bench["workloads"]:
        kind = (f"{dtypes[w['config']]} train" if "train" in w["traffic"]
                else "forward")
        keep = dict(LIMITS[kind])
        if "serve" not in w["traffic"]:
            keep.pop("decode_gap", None)
        with open(os.path.join(dest, "port_bench", "limits",
                               w["name"] + ".json"), "w") as f:
            json.dump(keep, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def run(root: str, workload: str, seed: int = 20251018, seconds=0.3,
        trace: int = 0, capsys=None) -> dict:
    """One run of a cut cell on the CPU; returns its result line."""
    from port_bench.run import main

    rc = main(["--workload", workload, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], root=root, device="cpu")
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
