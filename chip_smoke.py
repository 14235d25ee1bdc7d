"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits nonzero and prints no final `ok` line):
  1. device   — require CUDA; print the card's name and power limit;
  2. build    — compile the K1 kernel from wireframe_tpu_torch/csrc/;
  3. kernel   — K1 against its plain PyTorch version at the recipe's
                full width (bf16 weights, kv_pool 4, tile 512) on padded
                and all-padding samples;
  4. times    — K1, the plain version and K1's FLOP bound per shape;
  5. serving  — the full-width recipe WireframePredictor (random weights
                from a numpy seed, carried over through the flax bridge)
                serves synthetic .xyz clouds across all four point
                buckets; the K1 launch count must equal the batches
                served; .obj files must load back; one batch is compared
                between the kernel and the plain encoder chain; serving
                time per bucket, and a torch.profiler breakdown of one
                batch per bucket (device busy share, K1 against the rest).
Then a `kernels` JSON line and, last, the `ok` JSON line.

Imports torch, numpy and the port only: no JAX, nothing of wireframe_tpu.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (data sheet)
H100_BYTES_PER_S = 3.35e12    # HBM3
# K1 kernel against its plain version.  Both run bf16 operands with f32
# accumulation; they differ only in summation order, which flips the odd
# bf16 rounding of an activation (one bf16 ulp is 2^-8 relative).  The
# JAX package holds its Pallas kernel to rtol 2e-2, atol 2e-3
# (tests/test_pallas_encoder.py:50-63).  The pooled means meet that with
# room to spare (max 2e-5), but the per-point outputs (kv windows, maxima)
# carry each flip unaveraged: over ~10^6 features of magnitude ~1 the
# largest difference on the H100 was 6.4e-3, so atol is 1e-2, about 2.5
# bf16 ulps at 1.  The mean absolute difference must stay under 1e-3,
# which a wrong row, window or channel would break.  Each line also
# prints the plain bf16 chain against the plain f32 chain as a yardstick.
K1_RTOL, K1_ATOL, K1_MEAN_ATOL = 2e-2, 1e-2, 1e-3
# Whole model, kernel encoder against the plain chain, in bf16: the
# encoder's differences pass through ~30 more bf16 roundings in the
# decoder and edge head.  Vertices are in the unit-sphere frame, where
# one bf16 ulp is up to 2^-8 ~ 0.004; probabilities are in [0, 1].
MODEL_ATOL = {"vertices": 5e-2, "existence_probabilities": 2e-2,
              "edge_probs": 2e-2}
RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "configs", "recommended.yaml")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def recipe_encoder_params(torch, rng, device, input_dim=8,
                          hidden=(512, 1024, 2048, 1024), out=512):
    """Full-width encoder params with NONZERO biases and LayerNorm affine
    terms, so padding rows carry real features into the unmasked pools."""
    stages, prev = [], input_dim
    for h in hidden:
        stages.append(tuple(torch.tensor(a, device=device) for a in (
            (rng.standard_normal((prev, h)) / math.sqrt(prev)).astype(
                np.float32),
            (rng.standard_normal(h) * 0.1).astype(np.float32),
            (1.0 + rng.standard_normal(h) * 0.1).astype(np.float32),
            (rng.standard_normal(h) * 0.1).astype(np.float32))))
        prev = h
    fw = torch.tensor((rng.standard_normal((prev, out)) / math.sqrt(prev))
                      .astype(np.float32), device=device)
    fb = torch.tensor((rng.standard_normal(out) * 0.1).astype(np.float32),
                      device=device)
    # The kernel reads bf16 weights: hand both versions the same ones.
    stages = [(w.to(torch.bfloat16), b, g, be) for w, b, g, be in stages]
    return stages, fw.to(torch.bfloat16), fb


def padded_clouds(rng, b, n, d=8):
    """(b, n, d) clouds: sample 0 partly padded, the last sample all
    padding (when b > 1), others with a padded window mid-cloud."""
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    x[0, int(n * 0.6):] = 0.0
    if b > 1:
        x[-1] = 0.0
    if b > 2:
        x[1, 8:16] = 0.0
    return x


def cuda_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound_ms(b, n, d, hidden, out, kv_pool):
    """Least time for K1's work: operations at the bf16 peak against the
    bytes it must move (cloud in, bf16 weights, pools and kv out)."""
    dims = [d, *hidden, out]
    macs = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    flops = 2.0 * b * n * macs
    weight_bytes = 2 * macs + 4 * 3 * sum(hidden) + 4 * out
    io_bytes = 4 * b * n * d + 4 * b * 4 * out + 4 * b * (n // kv_pool) * out
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = (weight_bytes + io_bytes) / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def synthetic_building(rng, n, offset):
    """(n, 8) raw cloud: points on the walls and roof of a random box in
    world (UTM-like) coordinates, RGBA in [0, 255], LiDAR intensity."""
    size = rng.uniform([8, 8, 5], [30, 30, 15])
    face = rng.integers(0, 5, n)
    p = rng.uniform(0, 1, (n, 3)) * size
    p[face == 0, 0] = 0.0
    p[face == 1, 0] = size[0]
    p[face == 2, 1] = 0.0
    p[face == 3, 1] = size[1]
    p[face == 4, 2] = size[2]
    pc = np.zeros((n, 8))
    pc[:, :3] = p + offset + rng.normal(0, 0.02, (n, 3))
    pc[:, 3:7] = rng.uniform(0, 255, (n, 4))
    pc[:, 7] = rng.uniform(40000, 50000, n)
    return pc


def kernel_phase(torch, dev, card, shapes):
    """K1 against its plain version, then both timed, per (B, N) shape.
    Returns (max abs error, {(B, N): (ms, plain_ms, bound_ms, bound_by)})."""
    from wireframe_tpu_torch.ops.fused_encoder import (
        fused_point_encoder,
        fused_point_encoder_plain,
    )

    rng = np.random.default_rng(0)
    stages, fw, fb = recipe_encoder_params(torch, rng, dev)
    hidden = tuple(w.shape[1] for w, *_ in stages)
    kw = dict(tile=512, compute_dtype=torch.bfloat16, kv_pool=4)
    max_abs = 0.0
    timing = {}
    for b, n in shapes:
        x = torch.tensor(padded_clouds(rng, b, n), device=dev)
        got = fused_point_encoder(x, stages, fw, fb, **kw)
        want = fused_point_encoder_plain(x, stages, fw, fb, **kw)
        f32 = fused_point_encoder_plain(
            x, stages, fw, fb, **{**kw, "compute_dtype": torch.float32})
        torch.cuda.synchronize()
        for key in ("masked_mean", "masked_max", "mean", "max",
                    "kv_features"):
            g, w = got[key], want[key]
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"K1 {key} at B={b} N={n}: shape "
                                     f"{tuple(g.shape)} or non-finite")
            err = (g - w).abs()
            mean_err = err.mean().item()
            ok = bool((err <= K1_ATOL + K1_RTOL * w.abs()).all()) and (
                mean_err <= K1_MEAN_ATOL)
            max_abs = max(max_abs, err.max().item())
            yard = (w - f32[key]).abs().max().item()
            print(f"K1 B={b} N={n} {key:12s} max_abs {err.max().item():.3e}"
                  f" mean_abs {mean_err:.3e} (atol {K1_ATOL}, rtol "
                  f"{K1_RTOL}, mean {K1_MEAN_ATOL}) "
                  f"{'ok' if ok else 'FAIL'}; plain bf16 vs f32 max_abs "
                  f"{yard:.3e}", flush=True)
            if not ok:
                raise AssertionError(f"K1 {key} disagrees at B={b} N={n}")
        if b > 1:   # the all-padding sample pools to exactly zero
            for key in ("masked_mean", "masked_max", "kv_features"):
                if got[key][-1].abs().max().item() != 0.0:
                    raise AssertionError(f"all-padding sample {key} != 0")
        ms = cuda_ms(torch, lambda: fused_point_encoder(x, stages, fw, fb,
                                                        **kw), 10)
        plain_ms = cuda_ms(torch, lambda: fused_point_encoder_plain(
            x, stages, fw, fb, **kw), 3)
        bound, bound_by = k1_bound_ms(b, n, 8, hidden, fw.shape[1], 4)
        timing[(b, n)] = (ms, plain_ms, bound, bound_by)
        print(f"K1 time B={b} N={n}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}), "
              f"{bound / ms * 100:.1f}% of bound [{card}]", flush=True)
        del x, got, want, f32
    # Ragged edges the recipe never hits: M = B*N, widths and the output
    # not multiples of the 128-wide GEMM tiles, K not a multiple of 32,
    # an output width off the 8-wide vector path, a last pooling chunk
    # of 72 rows, and the call without kv tokens.
    small_stages, small_fw, small_fb = recipe_encoder_params(
        torch, rng, dev, hidden=(40, 72), out=36)
    x = torch.tensor(padded_clouds(rng, 2, 200), device=dev)
    for kv_pool in (4, 0):
        kw = dict(tile=200, compute_dtype=torch.bfloat16, kv_pool=kv_pool)
        got = fused_point_encoder(x, small_stages, small_fw, small_fb, **kw)
        want = fused_point_encoder_plain(x, small_stages, small_fw,
                                         small_fb, **kw)
        for key in want:
            err = (got[key] - want[key]).abs()
            ok = bool((err <= K1_ATOL + K1_RTOL * want[key].abs()).all()
                      and err.mean().item() <= K1_MEAN_ATOL)
            max_abs = max(max_abs, err.max().item())
            print(f"K1 ragged B=2 N=200 widths (40, 72)->36 kv_pool "
                  f"{kv_pool} {key:12s} max_abs {err.max().item():.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"K1 ragged {key} disagrees")
    return max_abs, timing


def serving_phase(torch, dev, card, work, overrides=(),
                  sizes=(1300, 2048, 3000, 4096, 6000, 8192, 12000, 20000)):
    """Serve synthetic .xyz clouds through the recipe WireframePredictor.
    Returns (K1 launches during predict_files, batches served)."""
    from wireframe_tpu_torch.bridge import (
        init_flax_params,
        params_from_flax,
        save_port_checkpoint,
    )
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.bucketing import choose_bucket
    from wireframe_tpu_torch.io.obj import load_wireframe
    from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
    from wireframe_tpu_torch.ops.fused_encoder import fused_point_encoder
    from wireframe_tpu_torch.serve import WireframePredictor

    rng = np.random.default_rng(1)
    cfg = load_config(RECIPE, list(overrides))
    ckpt = os.path.join(work, "ckpt")
    # Seed 1: its random decoder keeps every slot live (existence ~0.89),
    # so the decode, edge and .obj paths carry data (seed 0 keeps none).
    flax_params = init_flax_params(cfg.model, seed=1)
    save_port_checkpoint(ckpt, flax_params, cfg)
    predictor = WireframePredictor(ckpt, config=RECIPE, overrides=overrides,
                                   device=dev)
    m = predictor.cfg.model
    print(f"recipe: encoder {m.encoder_hidden_dims}->"
          f"{m.encoder_output_dim}, decoder {m.decoder_layers}x"
          f"{m.decoder_dim} heads {m.decoder_heads}, max_vertices "
          f"{m.max_vertices}, kv_pool {m.decoder_kv_pool}, "
          f"{m.compute_dtype}, batch {predictor.batch_size}, buckets "
          f"{predictor.buckets}", flush=True)
    t0 = time.perf_counter()
    predictor.warmup()
    print(f"warmup: {time.perf_counter() - t0:.2f} s", flush=True)

    offset = np.array([534000.0, 6588000.0, 40.0])
    paths = []
    for i, n in enumerate(sizes):
        p = os.path.join(work, f"cloud{i}_{n}.xyz")
        np.savetxt(p, synthetic_building(rng, n, offset), fmt="%.4f")
        paths.append(p)
    per_bucket = {}
    for n in sizes:
        bucket = choose_bucket(n, predictor.buckets)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    if sorted(per_bucket) != sorted(predictor.buckets) or max(sizes) <= max(
            predictor.buckets):
        raise AssertionError(f"clouds must hit every bucket and downsample "
                             f"once: {per_bucket}")
    batches = sum(-(-k // predictor.batch_size) for k in per_bucket.values())

    out_dir = os.path.join(work, "obj")
    fused_point_encoder.launches = 0
    results = predictor.predict_files(paths, out_dir=out_dir)
    launches = fused_point_encoder.launches
    print(f"served {len(paths)} clouds in {batches} batches; K1 launches "
          f"{launches}", flush=True)
    for p, r in zip(paths, results):
        v, e = r["vertices"], r["edges"]
        if not np.isfinite(v).all():
            raise AssertionError(f"non-finite vertices for {p}")
        if len(e) and (e.min() < 0 or e.max() >= r["num_vertices"]):
            raise AssertionError(f"edge index out of range for {p}")
        lv, le = load_wireframe(r["obj_path"])
        if lv.shape != v.shape or len(le) != r["num_edges"] or (
                len(v) and np.abs(lv - v).max() > 1e-3):
            raise AssertionError(f"{r['obj_path']} does not load back")
        if len(v) and np.linalg.norm(v.mean(0) - offset) > 100.0:
            raise AssertionError(f"vertices of {p} not in world frame")
        print(f"  {os.path.basename(p)}: {r['num_vertices']} vertices, "
              f"{r['num_edges']} edges -> {os.path.basename(r['obj_path'])}",
              flush=True)

    # Kernel encoder against the plain chain on one served batch.
    bucket = predictor.buckets[1]
    clouds = [np.loadtxt(p) for p in paths]
    pcs = [predictor._preprocess(c)["pc"] for c, n in zip(clouds, sizes)
           if choose_bucket(n, predictor.buckets) == bucket]
    xb = torch.tensor(predictor.batch_array(pcs, bucket), device=dev)
    plain_cfg = load_config(RECIPE, [*overrides,
                                     "model.use_pallas_encoder=false"])
    plain = PointCloudToWireframe(plain_cfg.model)
    plain.load_state_dict(params_from_flax(flax_params), strict=True)
    plain = plain.to(dev).eval()
    with torch.inference_mode():
        out_k = predictor.model(xb)
        out_p = plain(xb)
    for key, atol in MODEL_ATOL.items():
        if not torch.isfinite(out_k[key]).all():
            raise AssertionError(f"model {key} non-finite")
        err = (out_k[key] - out_p[key]).abs().max().item()
        print(f"model kernel vs plain chain, bucket {bucket}: {key} "
              f"max_abs {err:.3e} (atol {atol}) "
              f"{'ok' if err <= atol else 'FAIL'}", flush=True)
        if err > atol:
            raise AssertionError(f"model {key} disagrees: {err}")

    # Serving time per bucket: host clock around predict(), which ends in
    # a device -> host copy of the outputs; then one profiled batch.
    for bucket in predictor.buckets:
        chunk = [c for c, n in zip(clouds, sizes)
                 if choose_bucket(n, predictor.buckets) == bucket]
        nb = -(-len(chunk) // predictor.batch_size)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            predictor.predict(chunk)
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        print(f"serve bucket {bucket}: {t / nb * 1e3:.2f} ms/batch "
              f"(batch {predictor.batch_size}, {len(chunk)} clouds), "
              f"{len(chunk) / t:.1f} clouds/s [{card}]", flush=True)
        if torch.device(dev).type == "cuda":
            profile_batch(torch, predictor, chunk, bucket, card)
    return launches, batches


K1_KERNELS = ("gemm_bias_kernel", "ln_relu_kernel", "pool_partials_kernel",
              "pool_finalize_kernel")


def profile_batch(torch, predictor, chunk, bucket, card):
    """Where one served batch's time goes: device time by kernel from
    torch.profiler, against the host wall clock of the same predict()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    device_ms = sum(r[0] for r in rows)
    k1_ms = sum(r[0] for r in rows if any(k in r[2] for k in K1_KERNELS))
    print(f"profile bucket {bucket}: wall {wall_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms ({device_ms / wall_ms * 100:.1f}%), K1 "
          f"{k1_ms:.2f} ms, rest of the model {device_ms - k1_ms:.2f} ms, "
          f"{sum(r[1] for r in rows)} device ops [{card}]", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}", flush=True)


def main() -> int:
    import torch

    phase = "device"
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if not torch.cuda.is_available():
            print("FAILED: torch.cuda.is_available() is false; this smoke "
                  "test needs an NVIDIA GPU", flush=True)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(card, flush=True)
        print(f"device: {kind}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        dev = torch.device("cuda")

        phase = "build"
        from wireframe_tpu_torch.ops import _build

        path, secs, log = _build.build("fused_encoder")
        print(f"build: {path.name} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

        phase = "kernel and times"
        max_abs, timing = kernel_phase(
            torch, dev, card, ((3, 2048), (3, 16384), (64, 2560)))

        phase = "serving"
        launches, batches = serving_phase(torch, dev, card, work)
        if launches != batches:
            raise AssertionError(f"K1 launched {launches} times for "
                                 f"{batches} batches")

        b, n = 3, 16384
        ms, plain_ms, bound, bound_by = timing[(b, n)]
        print(json.dumps({"kernels": [{
            "name": "fused_point_encoder (K1)", "route": "cuda",
            "source": "wireframe_tpu_torch/csrc/fused_encoder.cu",
            "replaces": "wireframe_tpu/ops/pallas_encoder.py:71",
            "launches": launches, "max_abs_err": max_abs,
            "shape": f"B={b} N={n} kv_pool=4", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}]}), flush=True)
    except Exception:
        traceback.print_exc()
        print(f"FAILED in phase {phase}", flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
