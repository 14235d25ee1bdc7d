"""Benchmark: point-cloud -> wireframe inference throughput on one GPU.

    python -m wireframe_tpu_torch.bench            # from the repository root

Port of the repository's `bench.py`.  Measures clouds/sec at 2k-16k
points per cloud on the shipped recipe (configs/recommended.yaml: the
query decoder) and, in the same JSON line under "parity_arch", on the
reference-parity model (`Config()`, the MLP head).  Prints ONE JSON line,
last on stdout; progress goes to stderr.

Two protocols, as bench.py has them:
- throughput: one device scalar is chained through every iteration
  (the sum of each forward's mean vertex and edge probability) and read
  back once, over distinct pre-staged inputs, so the host never waits for
  the card inside the timed window;
- latency: each iteration reads back its own scalar, so every sample is
  a full dispatch -> card -> host round trip; true percentiles
  (nearest rank) over `BENCH_LAT_ITERS` trips.

`mfu` is the analytic matmul FLOPs of the inference forward
(`model_flops_per_cloud`, a lower bound; in train mode too, as bench.py
counts it) over the wall time and the card's dense bf16 tensor-core peak
(`BF16_PEAK_FLOPS`, NVIDIA's H100 data sheet; a card missing from the
table raises).  It is null on the CPU.  There is no `vs_baseline`:
bench.py divides by 625 clouds/sec/chip, a TPU v5e-8 target, and no TPU
figure is a target for the port.

Env knobs (bench.py's): BENCH_BATCH (128), BENCH_POINTS (2560),
BENCH_DTYPE (bfloat16 | float32; the fused encoder's kernels compute in
either, float32 on their 3xTF32 main loop; mfu stays against the bf16
peak, as bench.py's), BENCH_ITERS (30),
BENCH_LAT_ITERS (20), BENCH_TRAIN=1 (time the train step instead),
BENCH_PALLAS (1: the fused encoder kernels), BENCH_BUCKETS=2048,4096,...
(per-bucket latency at a roughly constant point budget),
BENCH_SWEEP=2048,4096,... (throughput at BENCH_SWEEP_BATCH, default
BENCH_BATCH, per point count), BENCH_CONFIG=<yaml|parity> (default the
recipe), BENCH_PARITY_SECONDARY=0 (skip the parity pass), BENCH_PROFILE=
<dir> (a torch.profiler Chrome trace of the timed throughput window).
`--device cpu` runs on the CPU with the kernels' plain versions; without
a GPU and without it the bench raises.

Besides bench.py's keys the line carries `param_bytes` (the model's
weights), `forward_calls` (forward mode: every model forward the run
made) or `steps` (train mode), which the chip smoke test holds the
kernels' launch counts to, and on the card `card_samples`: the SM and
memory clocks, power draw and temperature ([min, mean, max]) sampled
over the main measurement's warmup and timed window
(`utils.profiling.card_samples`), so that two readings can be compared
at their clocks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from wireframe_tpu_torch.config import RECIPE_YAML
from wireframe_tpu_torch.utils.profiling import log

WARMUP = 5

# Dense bf16 tensor-core peak (no sparsity) by torch.cuda.get_device_name(),
# from NVIDIA's H100 data sheet: the SXM part 989.4 TFLOP/s, PCIe 756.
BF16_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12,
                   "NVIDIA H100 PCIe": 756e12}


def model_flops_per_cloud(cfg, n_points: int) -> float:
    """Analytic matmul FLOPs per cloud for the inference forward — a
    LOWER bound (elementwise ops, LayerNorms, pooling and softmax
    excluded; 1 MAC = 2 FLOPs).  A copy of bench.py's count.

    Counted: per-point encoder MLP + fusion MLP (models/encoder.py),
    the query decoder's KV projection, per-layer self/cross attention
    and FFN (models/vertex_query_head.py), and the edge head's PairDense
    + pair MLP (models/edge_head.py).
    """
    m = cfg.model
    dims = [m.input_dim, *m.encoder_hidden_dims, m.encoder_output_dim]
    enc = 2 * n_points * sum(a * b for a, b in zip(dims, dims[1:]))
    c = m.encoder_output_dim
    fusion = 2 * ((2 * c) * (4 * c) + (4 * c) * (2 * c) + (2 * c) * c)
    v = m.max_vertices
    e = v * (v - 1) // 2
    if m.vertex_head == "query":
        d, ffn, nl = m.decoder_dim, m.decoder_ffn_dim, m.decoder_layers
        nk = -(-n_points // max(1, m.decoder_kv_pool))
        dec = 2 * nk * c * d                       # shared KV projection
        per_layer = (
            4 * 2 * v * d * d                      # self-attn qkv + out
            + 2 * v * d * d + 2 * 2 * nk * d * d   # cross q + k/v projs
            + 2 * 2 * v * nk * d                   # scores + AV
            + 2 * 2 * v * d * ffn                  # FFN in + out
        )
        dec += nl * per_layer
        head = 2 * v * (d * 3 + d * 1)             # coord + existence
    else:
        h = 4096
        dec = 2 * (c * h + h * 2048 + 2048 * 1024 + 1024 * v * 4)
        head = 0
    eh = m.edge_hidden_dim
    edge = (2 * v * (3 + 256) * eh                 # embed + PairDense l1
            + 4 * 2 * v * eh * eh                  # slot self-attn
            + 2 * e * (eh * 256 + 256 * 128 + 128))  # pair MLP
    return float(enc + fusion + dec + head + edge)


def bf16_peak_flops(device: torch.device) -> Optional[float]:
    """The card's dense bf16 peak; None on the CPU.  Raises for a card
    the table does not hold rather than divide by another card's peak."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if name not in BF16_PEAK_FLOPS:
        raise RuntimeError(f"no bf16 peak on record for {name!r}; add it to "
                           "BF16_PEAK_FLOPS from the card's data sheet")
    return BF16_PEAK_FLOPS[name]


def bench_config(path: str, points: int, dtype: str, use_pallas: bool):
    """The benchmarked config: `path` (a yaml, or "parity" for Config())
    with the bench's points, dtype and kernels; no device augmentation."""
    from wireframe_tpu_torch.config import load_config

    cfg = load_config(None if path == "parity" else path)
    cfg.data.num_points = points
    cfg.model.compute_dtype = dtype
    cfg.model.use_pallas_encoder = use_pallas
    cfg.train.device_augment = False
    cfg.__post_init__()
    return cfg


def run(env: Mapping[str, str], device=None) -> Dict:
    """The bench with the knobs of `env` (os.environ's names); returns
    the result that `main` prints."""
    from wireframe_tpu_torch.train.loop import device_batch, init_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import (
        make_forward_fn,
        make_train_step,
    )
    from wireframe_tpu_torch.utils.platform import card_line, resolve_device
    from wireframe_tpu_torch.utils.profiling import (
        card_samples,
        chained_seconds,
        round_trips,
        staged_clouds,
    )
    from wireframe_tpu_torch.utils.synth import make_random_batch
    from wireframe_tpu_torch.utils.trees import tree_size_bytes

    dev = resolve_device(device)
    batch = int(env.get("BENCH_BATCH", "128"))
    points = int(env.get("BENCH_POINTS", "2560"))
    dtype = env.get("BENCH_DTYPE", "bfloat16")
    iters = int(env.get("BENCH_ITERS", "30"))
    lat_iters = int(env.get("BENCH_LAT_ITERS", "20"))
    bench_train = env.get("BENCH_TRAIN", "0") == "1"
    use_pallas = env.get("BENCH_PALLAS", "1") == "1"
    cfg_path = env.get("BENCH_CONFIG", "") or (
        str(RECIPE_YAML) if RECIPE_YAML.exists() else "parity")
    peak = bf16_peak_flops(dev)

    cfg = bench_config(cfg_path, points, dtype, use_pallas)
    arch = "parity-mlp" if cfg_path == "parity" else (
        f"{cfg.model.vertex_head}-head recipe")
    log("bench", f"init params [{arch}] on {dev}")
    model = init_model(cfg, dev, seed=0)
    r = np.random.default_rng(0)

    def mfu(c, n_pts, clouds_per_sec):
        if peak is None:
            return None
        return model_flops_per_cloud(c, n_pts) * clouds_per_sec / peak

    result = {}
    if bench_train:
        state = create_train_state(cfg, model)
        step = make_train_step(cfg)
        tb = device_batch(make_random_batch(cfg, batch, seed=0), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        # The step updates the state in place, so each step reads the
        # last one's weights; the chained loss waits for them all.
        log("bench", "train warmup, then timing")
        with card_samples(dev) as card:
            dt = iters * chained_seconds(
                lambda s, i: s + step(state, tb, gen)[1]["total_loss"],
                iters, dev, warmup=WARMUP)
        metric = "train_clouds_per_sec_per_chip"
        result["steps"] = WARMUP + iters
    else:
        forward = make_forward_fn(cfg)
        calls = [0]

        def fwd(mdl, x):
            calls[0] += 1
            return forward(mdl, x)

        def chain(mdl, xs):
            """call(s, i) for chained_seconds: one forward on input i."""
            def call(s, i):
                o = fwd(mdl, xs[i % len(xs)])
                return (s + o["vertices"].float().mean()
                        + o["edge_probs"].mean())
            return call

        def measure_forward(mdl, xs, tag, profile=None):
            log("bench", f"warmup, then {iters} timed iters [{tag}]")
            return iters * chained_seconds(chain(mdl, xs), iters, dev,
                                           warmup=WARMUP, profile_dir=profile)

        def measure_latency(xs, bs):
            """Individually timed dispatch -> host read-back round trips."""
            def call(i):
                o = fwd(model, xs[i % len(xs)])
                return float(o["vertices"].float().mean()
                             + o["edge_probs"].mean())
            return round_trips(call, lat_iters, items_per_step=bs)

        # Distinct pre-staged inputs: no two consecutive iterations read
        # the same cloud.
        d = cfg.model.input_dim
        xs = staged_clouds(r, batch, points, d, min(iters, 8), dev)
        with card_samples(dev) as card:
            dt = measure_forward(model, xs, arch, env.get("BENCH_PROFILE"))
        metric = "clouds_per_sec_per_chip"

        log("bench", f"latency: {lat_iters} timed round trips")
        s = measure_latency(xs, batch)
        result["latency_ms"] = {
            "p50": s["p50_s"] * 1e3, "p90": s["p90_s"] * 1e3,
            "p99": s["p99_s"] * 1e3,
            "per_cloud_p50": s["p50_s"] * 1e3 / batch, "iters": s["steps"]}

        if (cfg_path != "parity"
                and env.get("BENCH_PARITY_SECONDARY", "1") == "1"):
            pcfg = bench_config("parity", points, dtype, use_pallas)
            pmodel = init_model(pcfg, dev, seed=0)
            pdt = measure_forward(pmodel, xs, "parity-mlp")
            del pmodel
            result["parity_arch"] = {
                "value": batch * iters / pdt,
                "mean_batch_ms": pdt / iters * 1e3,
                "mfu": mfu(pcfg, points, batch * iters / pdt),
                "max_vertices": pcfg.model.max_vertices}

        buckets_env = env.get("BENCH_BUCKETS", "")
        if buckets_env:
            result["buckets"] = {}
            for bucket in (int(t) for t in buckets_env.split(",")):
                # Keep the point budget roughly constant across buckets.
                bb = max(8, min(batch, (batch * points) // bucket))
                log("bench", f"bucket {bucket}: {lat_iters} round trips "
                    f"(batch {bb})")
                sb = measure_latency(staged_clouds(r, bb, bucket, d, 4, dev),
                                     bb)
                result["buckets"][str(bucket)] = {
                    "batch": bb, "p50_ms": sb["p50_s"] * 1e3,
                    "p99_ms": sb["p99_s"] * 1e3,
                    "per_cloud_p50_ms": sb["p50_s"] * 1e3 / bb,
                    # Serialized round trips (each awaits its read-back),
                    # not the pipelined throughput above.
                    "round_trip_clouds_per_sec": sb["items_per_sec"]}

        sweep_env = env.get("BENCH_SWEEP", "")
        if sweep_env:
            # Pipelined throughput per point count at a fixed batch.  The
            # model does not depend on the point count: one model serves.
            sweep_batch = int(env.get("BENCH_SWEEP_BATCH", str(batch)))
            result["sweep"] = {}
            for n_pts in (int(t) for t in sweep_env.split(",")):
                try:
                    sx = staged_clouds(r, sweep_batch, n_pts, d, 4, dev)
                    sdt = iters * chained_seconds(chain(model, sx), iters,
                                                  dev, warmup=WARMUP)
                except torch.cuda.OutOfMemoryError as exc:
                    log("bench", f"sweep {n_pts} does not fit: {exc}")
                    result["sweep"][str(n_pts)] = {"error": str(exc)[:200]}
                    continue
                scps = sweep_batch * iters / sdt
                result["sweep"][str(n_pts)] = {
                    "batch": sweep_batch, "clouds_per_sec": scps,
                    "mean_batch_ms": sdt / iters * 1e3,
                    "mfu": mfu(cfg, n_pts, scps)}
                log("bench", f"sweep {n_pts}: {scps:.1f} clouds/s")
        result["forward_calls"] = calls[0]
    if card:
        result["card_samples"] = card

    clouds_per_sec = batch * iters / dt
    return {
        "metric": metric, "value": clouds_per_sec,
        "unit": "clouds/sec/chip", "arch": arch, "config": cfg_path,
        "batch": batch, "points": points, "dtype": dtype,
        "device": card_line(dev),
        # Mean batch wall time over the chained loop, not a percentile.
        "mean_batch_ms": dt / iters * 1e3,
        "mfu": mfu(cfg, points, clouds_per_sec),
        "param_bytes": tree_size_bytes(model.state_dict()),
        **result}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print(json.dumps(run(os.environ, device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
