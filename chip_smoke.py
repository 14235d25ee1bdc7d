"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits nonzero and prints no final `ok` line):
  1. device   — require CUDA; print the card's name and power limit;
  2. build    — compile K1 (fused_encoder.cu), K2 + K3 (chain_grad.cu) and
                K4 (lockstep_lsa.cu) from wireframe_tpu_torch/csrc/, one
                nvcc per source, all started together; ptxas lines;
  3. K1       — against its plain PyTorch version at the recipe's full
                width (bf16 weights, kv_pool 4, tile 512) on padded and
                all-padding samples; K1, the plain version and K1's FLOP
                bound per shape;
  4. K4       — the lockstep JV kernel against its plain version, exactly,
                at (8, 40, 40) with random counts and with forced ties and
                at (64, 40, 128); assignment cost against scipy; times;
  5. K2 / K3  — the stash chain forward and backward against their plain
                versions at the recipe's training shape (8, 2560), full
                width, plus small ragged shapes in all three flavours;
                times and bounds;
  6. training — the full-width recipe train step (train_model, overfit
                one synthetic batch of 8 box buildings, 20 steps): finite
                losses, K2 / K3 / K4 launched once per step each; the first
                3 losses against the same steps with the plain versions on
                the card; a 30-step constant-LR run whose loss falls; ms per
                step, clouds/s and a torch.profiler breakdown of one step;
                the trained weights saved through the bridge and served;
  7. serving  — the full-width recipe WireframePredictor (random weights
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

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (data sheet)
H100_BYTES_PER_S = 3.35e12    # HBM3
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores (data sheet)
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
    """(n, 8) raw cloud of a random box building in world (UTM-like)
    coordinates."""
    from wireframe_tpu_torch.utils.synth import box_building_cloud

    pc, _ = box_building_cloud(rng, n)
    pc[:, :3] += offset
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


def device_rows(prof):
    """(ms, count, name) of every kernel the profile saw.  Only the
    device-side events: an operator's row also carries the device time of
    the kernels it launched, so summing both would count them twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    return rows


K1_KERNELS = ("gemm_kernel", "ln_relu_kernel", "pool_partials_kernel",
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
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows)
    k1_ms = sum(r[0] for r in rows if any(k in r[2] for k in K1_KERNELS))
    print(f"profile bucket {bucket}: wall {wall_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms ({device_ms / wall_ms * 100:.1f}%), K1 "
          f"{k1_ms:.2f} ms, rest of the model {device_ms - k1_ms:.2f} ms, "
          f"{sum(r[1] for r in rows)} device ops [{card}]", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}", flush=True)


# ---------------------------------------------------------------------------
# K4: the lockstep JV matcher
# ---------------------------------------------------------------------------

def k4_phase(torch, dev, card):
    """K4 against its plain version (exact) and scipy (cost within 1e-5);
    times at the recipe's (8, 40, 40).  Returns the JSON fields."""
    from scipy.optimize import linear_sum_assignment

    from wireframe_tpu_torch.ops.lockstep_lsa import (
        solve_lsa_rows,
        solve_lsa_rows_lockstep_plain,
    )

    rng = np.random.default_rng(4)
    cases = []
    for b, r, c in ((8, 40, 40), (64, 40, 128)):
        counts = rng.integers(4, 39, size=b).astype(np.int32)
        cases.append((f"random ({b}, {r}, {c})",
                      (rng.random((b, r, c)) * 10).astype(np.float32),
                      counts))
        cases.append((f"ties ({b}, {r}, {c})",
                      (rng.integers(0, 4, (b, r, c)) * 0.5).astype(
                          np.float32), counts))
    for name, cost, counts in cases:
        ct = torch.tensor(cost, device=dev)
        nt = torch.tensor(counts, device=dev)
        got = solve_lsa_rows(ct, nt)
        want = solve_lsa_rows_lockstep_plain(ct, nt)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        g = got.cpu().numpy()
        worst = 0.0
        for i, k in enumerate(counts):
            rows, cols = linear_sum_assignment(cost[i, :k])
            best = cost[i, rows, cols].sum()
            have = cost[i, np.arange(k), g[i, :k]].sum()
            if len(set(g[i, :k].tolist())) != k or (g[i, k:] != -1).any():
                raise AssertionError(f"K4 {name}: sample {i} not an "
                                     "assignment")
            worst = max(worst, abs(have - best) / max(abs(best), 1e-12))
        print(f"K4 {name}: array_equal to plain {equal}; worst relative "
              f"cost gap to scipy {worst:.2e} (limit 1e-5)", flush=True)
        if not equal or worst > 1e-5:
            raise AssertionError(f"K4 {name} disagrees")

    # Times at the recipe's shape: B=8 samples, R=C=40, counts 4-38.
    cost, counts = cases[0][1], cases[0][2]
    ct = torch.tensor(cost, device=dev)
    nt = torch.tensor(counts, device=dev)
    steps = torch.zeros(8, dtype=torch.int32, device=dev)
    solve_lsa_rows(ct, nt, steps_out=steps)
    ms = cuda_ms(torch, lambda: solve_lsa_rows(ct, nt), 20)
    plain_ms = cuda_ms(torch, lambda: solve_lsa_rows_lockstep_plain(ct, nt),
                       1)
    # Work this input needs: every scan step relaxes C columns (add, 2 sub,
    # compare, select, min) and scans them again for the argmin (compare,
    # 2 min): ~9 f32 operations per column per step.
    total_steps = int(steps.sum())
    ops = total_steps * 40 * 9
    nbytes = cost.nbytes + counts.nbytes + 8 * 40 * 4
    t_ops = ops / H100_F32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(f"K4 time (8, 40, 40): kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          f"ms, {total_steps} scan steps (longest sample "
          f"{int(steps.max())}), bound {bound:.2e} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}); the "
          f"kernel is latency-bound by its sequential scan [{card}]",
          flush=True)
    return {"shape": "B=8 R=40 C=40", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": 0.0}


# ---------------------------------------------------------------------------
# K2 / K3: the stash chain
# ---------------------------------------------------------------------------

# K3 against its plain version.  Both round dz to bf16 before the products
# and sum in other orders, so single bf16 roundings flip (2^-8 relative)
# and a ReLU gate where ln is within float noise of 0 can flip; each
# gradient tensor is held to a max error of 2e-2 and a mean error of 5e-3,
# relative to its largest and its mean magnitude (a wrong row, column or
# stage gives O(1)).
K3_MAX_REL, K3_MEAN_REL = 2e-2, 5e-3


def bf16_ulp(torch, v):
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    _, e = torch.frexp(v.abs().float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def chain_bound_ms(b, n, d, hidden, out, kv_pool, backward):
    """Least time for K2's (forward) or K3's (backward) work: bf16
    tensor-core operations against the bytes each must move."""
    dims = [d, *hidden, out]
    macs = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    m = b * n
    stash = 2 * m * sum(hidden)
    kv = 3 * 4 * m // kv_pool * out
    weights = 2 * macs + 4 * (3 * sum(hidden) + out)
    if backward:
        flops = 4.0 * m * macs
        nbytes = 4 * m * d + stash + kv + weights + 4 * (
            macs + 3 * sum(hidden) + out) + 4 * m * d
    else:
        flops = 2.0 * m * macs
        nbytes = 4 * m * d + weights + stash + kv
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


CHAIN_SHAPES = (
    # (name, B, N, hidden widths, output width, kv_pool, emit features)
    ("recipe", 8, 2560, (512, 1024, 2048, 1024), 512, 4, False),
    ("ragged kv", 2, 200, (40, 72), 36, 4, True),
    ("ragged features", 2, 256, (40, 72), 36, 0, True))


def chain_phase(torch, dev, card, shapes=CHAIN_SHAPES):
    """K2 and K3 against their plain versions, then timed at the recipe's
    shape.  Returns ({"K2": fields, "K3": fields})."""
    from wireframe_tpu_torch.ops.chain_grad import (
        chain_backward,
        chain_backward_plain,
        chain_forward,
        chain_forward_plain,
    )

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bf = torch.bfloat16
    result = {}
    for name, b, n, hidden, out, p, emit in shapes:
        stages, fw, fb = recipe_encoder_params(torch, rng, dev,
                                               hidden=hidden, out=out)
        x = torch.tensor(padded_clouds(rng, b, n), device=dev)
        kw = dict(kv_pool=p, compute_dtype=bf)
        got = chain_forward(x, stages, fw, fb, emit_features=emit, **kw)
        want = chain_forward_plain(x, stages, fw, fb, emit_features=True,
                                   **kw)
        torch.cuda.synchronize()
        max_abs = bwd_abs = 0.0
        keys = (["pooled", "sums"] if p else []) + (["features"] if emit
                                                     else [])
        for key in keys:
            g, w = got[key], want[key]
            err = (g - w).abs()
            ok = bool((err <= K1_ATOL + K1_RTOL * w.abs()).all()) and (
                err.mean().item() <= K1_MEAN_ATOL)
            max_abs = max(max_abs, err.max().item())
            print(f"K2 {name} ({b}, {n}) {key:8s} max_abs "
                  f"{err.max().item():.3e} mean_abs {err.mean().item():.3e}"
                  f" (K1's atol {K1_ATOL}, rtol {K1_RTOL}, mean "
                  f"{K1_MEAN_ATOL}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"K2 {key} disagrees ({name})")
        # The stash: within one bf16 ulp of the plain version, at the
        # scale of its row.  Stage 0 differs only by the f32 sums' order
        # (a flip of one rounding); a later stage's z also carries the
        # flips of the bf16 activations before it, W dh, whose size is set
        # by the row's scale and not by a small element's own ulp.
        for k, (g, w) in enumerate(zip(got["zs"], want["zs"])):
            g, w = g.float(), w.float()
            diff = (g - w).abs()
            elem = (diff <= bf16_ulp(torch, torch.maximum(
                g.abs(), w.abs()))).float().mean().item()
            row_ulp = bf16_ulp(torch, w.abs().amax(-1, keepdim=True))
            within = (diff <= row_ulp).float().mean().item()
            exact = (diff == 0).float().mean().item()
            print(f"K2 {name} z{k} (width {w.shape[-1]}): exact "
                  f"{exact * 100:.4f}%, within one ulp of the element "
                  f"{elem * 100:.4f}%, within one ulp of the row's max "
                  f"{within * 100:.4f}%", flush=True)
            if within < 1.0:
                raise AssertionError(f"K2 stash z{k} off by more than one "
                                     f"ulp ({name})")
        if p:
            f = want["features"]
            valid = x.sum(-1).abs() > 1e-9
            filled = torch.where(valid[..., None], f,
                                 torch.full_like(f, -torch.inf))
            top2 = torch.topk(filled.reshape(b, n // p, p, -1), 2,
                              dim=2).values
            gap = top2[:, :, 0] - top2[:, :, 1]
            clear = ~(gap <= K1_ATOL)        # NaN (empty window) compares
            agree = (got["idx"] == want["idx"])
            frac = agree.float().mean().item()
            print(f"K2 {name} idx: agreement {frac * 100:.4f}% overall, "
                  f"{agree[clear].float().mean().item() * 100:.4f}% where "
                  f"the top-two gap exceeds {K1_ATOL} "
                  f"({clear.float().mean().item() * 100:.2f}% of windows)",
                  flush=True)
            if not bool(agree[clear].all()):
                raise AssertionError(f"K2 idx disagrees ({name})")
            if b > 1:
                if got["pooled"][-1].abs().max().item() != 0.0:
                    raise AssertionError("all-padding sample pools != 0")

        cot = {}
        if p:
            cot = dict(dpool=torch.randn(want["pooled"].shape, device=dev,
                                         generator=gen),
                       dsums=torch.randn(want["sums"].shape, device=dev,
                                         generator=gen) * 0.1,
                       idx=want["idx"])
        if emit:
            cot["g"] = torch.randn(want["features"].shape, device=dev,
                                   generator=gen) * 0.1
        zs = want["zs"]
        gk = chain_backward(x, stages, fw, fb, zs, **kw, **cot)
        gp = chain_backward_plain(x, stages, fw, fb, zs, **kw, **cot)
        torch.cuda.synchronize()
        flat = lambda r: [("dx", r[0])] + [  # noqa: E731
            (f"{t}{i}", v) for i, st in enumerate(r[1])
            for t, v in zip(("dW", "db", "dgamma", "dbeta"), st)] + [
            ("dW_proj", r[2]), ("db_proj", r[3])]
        worst_max = worst_mean = 0.0
        for (label, a), (_, w) in zip(flat(gk), flat(gp)):
            err = (a - w).abs()
            rel_max = (err.max() / w.abs().max().clamp_min(1e-30)).item()
            rel_mean = (err.mean() / w.abs().mean().clamp_min(1e-30)).item()
            worst_max, worst_mean = (max(worst_max, rel_max),
                                     max(worst_mean, rel_mean))
            bwd_abs = max(bwd_abs, err.max().item())
            if rel_max > K3_MAX_REL or rel_mean > K3_MEAN_REL:
                raise AssertionError(
                    f"K3 {label} disagrees ({name}): max rel {rel_max:.2e}"
                    f", mean rel {rel_mean:.2e}")
        print(f"K3 {name} ({b}, {n}): dx and {len(flat(gp)) - 1} parameter "
              f"gradients, worst max rel err {worst_max:.2e} (limit "
              f"{K3_MAX_REL}), worst mean rel err {worst_mean:.2e} (limit "
              f"{K3_MEAN_REL}) ok", flush=True)

        if name == "recipe":
            fwd = lambda: chain_forward(  # noqa: E731
                x, stages, fw, fb, emit_features=False, **kw)
            bwd = lambda: chain_backward(  # noqa: E731
                x, stages, fw, fb, zs, **kw, **cot)
            for label, fn, plain, backward in (
                    ("K2", fwd, lambda: chain_forward_plain(
                        x, stages, fw, fb, emit_features=False, **kw), False),
                    ("K3", bwd, lambda: chain_backward_plain(
                        x, stages, fw, fb, zs, **kw, **cot), True)):
                ms = cuda_ms(torch, fn, 10)
                plain_ms = cuda_ms(torch, plain, 3)
                bound, bound_by = chain_bound_ms(b, n, 8, hidden, out, p,
                                                 backward)
                print(f"{label} time ({b}, {n}): kernel {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
                      f"({bound_by}), {bound / ms * 100:.1f}% of bound; "
                      f"library: none (no single PyTorch call computes it) "
                      f"[{card}]", flush=True)
                result[label] = {"shape": f"B={b} N={n} kv_pool={p}",
                                 "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": bound_by,
                                 "max_abs_err": 0.0}
            result["K2"]["max_abs_err"] = max_abs
            result["K3"]["max_abs_err"] = bwd_abs
        del x, got, want, gk, gp
    return result


# ---------------------------------------------------------------------------
# Training: the recipe train step
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20
FALL_STEPS = 30
# The first steps with the kernels against the same steps with the plain
# versions on the card: bf16 throughout, the two differ by K2's rounding
# flips (pooled kv within 1e-2), carried through the decoder and the loss;
# warmup makes the first update 0 and the next two tiny.
TRAIN_LOSS_RTOL = 1e-2


class _Losses:
    def __init__(self):
        self.rows = []

    def log(self, row):
        self.rows.append(row)


@contextlib.contextmanager
def plain_kernels():
    """Route K2, K3 and K4's CUDA tensors through their plain versions."""
    from wireframe_tpu_torch.ops import chain_grad, lockstep_lsa

    saved = (chain_grad._forward_cuda, chain_grad._backward_cuda,
             lockstep_lsa._launch)
    chain_grad._forward_cuda = (
        lambda x, sp, fw, fb, **kw: chain_grad.chain_forward_plain(
            x, sp, fw, fb, **kw))
    chain_grad._backward_cuda = (
        lambda x, sp, fw, fb, zs, **kw: chain_grad.chain_backward_plain(
            x, sp, fw, fb, zs, **kw))
    lockstep_lsa._launch = (
        lambda cost, nr, steps_out: lockstep_lsa
        .solve_lsa_rows_lockstep_plain(cost, nr))
    try:
        yield
    finally:
        (chain_grad._forward_cuda, chain_grad._backward_cuda,
         lockstep_lsa._launch) = saved


TRAIN_KERNELS = {
    "K2": ("ln_relu_stash", "window_pool", "float, false, false>",
           "__nv_bfloat16, false, false>"),
    "K3": ("seed_kernel", "row_bwd", "colsum", "row_valid",
           "false, true>", "true, false>"),
    "K4": ("lsa_kernel",),
}


def training_phase(torch, dev, card, work):
    """Train the full-width recipe; returns the launch counts of the
    20-step main-path run."""
    from wireframe_tpu_torch.bridge import (
        save_port_checkpoint,
        state_dict_to_flax,
    )
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.io.obj import load_wireframe
    from wireframe_tpu_torch.ops.chain_grad import (
        chain_backward,
        chain_forward,
    )
    from wireframe_tpu_torch.ops.lockstep_lsa import solve_lsa_rows
    from wireframe_tpu_torch.serve import WireframePredictor
    from wireframe_tpu_torch.train.loop import device_batch, train_model
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.synth import make_box_building_batch

    base = ["train.overfit_one_batch=true", "train.log_every=1"]
    cfg = load_config(RECIPE, base + [f"train.num_epochs={TRAIN_STEPS}"])
    m, t = cfg.model, cfg.train
    print(f"training recipe: encoder {m.encoder_hidden_dims}->"
          f"{m.encoder_output_dim}, decoder {m.decoder_layers}x"
          f"{m.decoder_dim} heads {m.decoder_heads} ffn {m.decoder_ffn_dim}, "
          f"edge head {m.edge_hidden_dim}/{m.edge_num_heads}, max_vertices "
          f"{m.max_vertices}, kv_pool {m.decoder_kv_pool}, chain tile "
          f"{m.pallas_chain_tile}, {m.compute_dtype}, chain_backward "
          f"{m.chain_backward}, batch {t.batch_size} x "
          f"{cfg.data.num_points} points, lr {t.learning_rate} "
          f"{t.lr_schedule} (warmup {t.warmup_steps}), EMA {t.ema_decay}, "
          f"matcher {t.matcher}, dropout attn {m.attn_dropout} edge "
          f"{m.edge_dropout}, augment jitter {t.aug_jitter_std} scale "
          f"{t.aug_scale_range}", flush=True)
    batch = make_box_building_batch(cfg, t.batch_size, seed=0)

    # The main path: counts to 0, 20 steps, counts read.
    writer = _Losses()
    chain_forward.launches = chain_backward.launches = 0
    solve_lsa_rows.launches = 0
    t0 = time.perf_counter()
    state = train_model(cfg, [batch], metric_writer=writer, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"K2": chain_forward.launches, "K3": chain_backward.launches,
                "K4": solve_lsa_rows.launches}
    losses = [r["total_loss"] for r in writer.rows]
    print(f"train {TRAIN_STEPS} steps in {secs:.2f} s, metrics read back "
          f"every step; losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}", flush=True)
    print(f"train launches over {TRAIN_STEPS} steps: {launches}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError("a training loss is not finite")
    if any(v != TRAIN_STEPS for v in launches.values()):
        raise AssertionError(f"kernels not launched once per step: "
                             f"{launches}")

    # The same first 3 steps with the plain versions on the card.
    plain_cfg = load_config(RECIPE, base + ["train.num_epochs=3"])
    plain_writer = _Losses()
    with plain_kernels():
        train_model(plain_cfg, [batch], metric_writer=plain_writer,
                    device=dev)
    plain_losses = [r["total_loss"] for r in plain_writer.rows]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:3], plain_losses)]
    print(f"train first 3 losses, kernels {losses[:3]} vs plain versions "
          f"{plain_losses}: max rel diff {max(rel):.2e} (rtol "
          f"{TRAIN_LOSS_RTOL})", flush=True)
    if max(rel) > TRAIN_LOSS_RTOL:
        raise AssertionError("training losses differ from the plain run")

    # Warmup from lr 0 moves little in 20 steps: show the loss falls at
    # the recipe's peak LR.
    fall = ["train.lr_schedule=constant", f"train.num_epochs={FALL_STEPS}"]
    print(f"train {FALL_STEPS} steps with the override {fall}", flush=True)
    fall_writer = _Losses()
    fall_cfg = load_config(RECIPE, base + fall)
    fall_state = train_model(fall_cfg, [batch], metric_writer=fall_writer,
                             device=dev)
    fl = [r["total_loss"] for r in fall_writer.rows]
    first, last = float(np.mean(fl[:3])), float(np.mean(fl[-3:]))
    print(f"train constant LR: mean loss of the first 3 steps {first:.5f}, "
          f"of the last 3 {last:.5f}; losses "
          f"{', '.join(f'{v:.4f}' for v in fl)}", flush=True)
    if not all(map(math.isfinite, fl)) or not last < first:
        raise AssertionError("the constant-LR loss does not fall")

    # ms per step: the step alone, no metric read-back, after warm-up.
    step = make_train_step(cfg)
    dbatch = device_batch(batch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for _ in range(2):
        step(state, dbatch, gen)
    torch.cuda.synchronize()
    n_timed = 10
    t0 = time.perf_counter()
    for _ in range(n_timed):
        step(state, dbatch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_timed * 1e3
    print(f"train step: {step_ms:.2f} ms/step, "
          f"{t.batch_size / step_ms * 1e3:.1f} training clouds/s (batch "
          f"{t.batch_size} x {cfg.data.num_points} points, host clock over "
          f"{n_timed} steps ending in a synchronize) [{card}]", flush=True)
    profile_train_step(torch, step, state, dbatch, gen, card)

    # No host sync inside the step: CUDA's sync debug mode flags every
    # operation that waits for the device (a read-back, a blocking copy).
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state, dbatch, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # Setting the mode also warns that it is a prototype: count only the
    # operations it flags.
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"train step under CUDA sync debug mode: {len(syncs)} "
          f"synchronizing operations", flush=True)
    for w in syncs[:10]:
        print(f"  {w.filename}:{w.lineno}: {str(w.message)[:80]}",
              flush=True)
    if syncs:
        raise AssertionError("the train step synchronizes with the host")

    # The trained weights, through the bridge, served.
    with torch.no_grad():
        probs = fall_state.model.eval()(dbatch["point_clouds"])[
            "existence_probabilities"]
    print(f"trained model on its own batch: existence > 0.5 in "
          f"{int((probs > 0.5).sum())} of {probs.numel()} slots (8 corners "
          f"a cloud), max {float(probs.max()):.3f}", flush=True)
    ckpt = os.path.join(work, "trained")
    save_port_checkpoint(ckpt, state_dict_to_flax(
        fall_state.model.state_dict(), cfg.model), cfg)
    predictor = WireframePredictor(ckpt, config=RECIPE, device=dev)
    rng = np.random.default_rng(2)
    offset = np.array([534000.0, 6588000.0, 40.0])
    paths = []
    for i, n in enumerate((2400, 5000)):
        pth = os.path.join(work, f"trained_cloud{i}.xyz")
        np.savetxt(pth, synthetic_building(rng, n, offset), fmt="%.4f")
        paths.append(pth)
    out_dir = os.path.join(work, "trained_obj")
    for pth, r in zip(paths, predictor.predict_files(paths,
                                                     out_dir=out_dir)):
        v, e = r["vertices"], r["edges"]
        lv, le = load_wireframe(r["obj_path"])
        if not np.isfinite(v).all() or lv.shape != v.shape or (
                len(le) != r["num_edges"]):
            raise AssertionError(f"trained checkpoint: {pth} does not "
                                 "serve and load back")
        print(f"served trained checkpoint: {os.path.basename(pth)} -> "
              f"{r['num_vertices']} vertices, {r['num_edges']} edges, "
              f"{os.path.basename(r['obj_path'])} loads back", flush=True)
    return launches, step_ms


def profile_train_step(torch, step, state, batch, gen, card):
    """Where one train step's time goes: device time by kernel from
    torch.profiler against the host wall clock of the same step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows)
    per = {k: sum(r[0] for r in rows if any(s in r[2] for s in subs))
           for k, subs in TRAIN_KERNELS.items()}
    rest = device_ms - sum(per.values())
    print(f"profile train step: wall {wall_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms ({device_ms / wall_ms * 100:.1f}%), K2 "
          f"{per['K2']:.2f} ms, K3 {per['K3']:.2f} ms, K4 {per['K4']:.3f} "
          f"ms, rest of the step {rest:.2f} ms, "
          f"{sum(r[1] for r in rows)} device ops [{card}]", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:10]:
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

        t0 = time.perf_counter()
        built = _build.build_all(["fused_encoder", "chain_grad",
                                  "lockstep_lsa"])
        print(f"build: {len(built)} libraries in "
              f"{time.perf_counter() - t0:.1f} s (in parallel)", flush=True)
        for name, (path, secs, log) in built.items():
            print(f"  {path.name}: {secs:.1f} s", flush=True)
            for line in log.splitlines():
                if ("Function properties" in line or "registers" in line
                        or "spill" in line):
                    print(f"    ptxas: {line.strip()[:110]}")

        phase = "K1 kernel and times"
        k1_abs, timing = kernel_phase(
            torch, dev, card, ((3, 2048), (3, 16384), (64, 2560)))

        phase = "K4 kernel and times"
        k4 = k4_phase(torch, dev, card)

        phase = "K2 / K3 kernels and times"
        chain = chain_phase(torch, dev, card)

        phase = "training"
        train_launches, _ = training_phase(torch, dev, card, work)

        phase = "serving"
        launches, batches = serving_phase(torch, dev, card, work)
        if launches != batches:
            raise AssertionError(f"K1 launched {launches} times for "
                                 f"{batches} batches")

        b, n = 3, 16384
        ms, plain_ms, bound, bound_by = timing[(b, n)]
        src = "wireframe_tpu_torch/csrc/"
        kernels = [{
            "name": "fused_point_encoder (K1)", "route": "cuda",
            "source": src + "fused_encoder.cu",
            "replaces": "wireframe_tpu/ops/pallas_encoder.py:71",
            "launches": launches, "max_abs_err": k1_abs,
            "shape": f"B={b} N={n} kv_pool=4", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}]
        for key, name, source, replaces, fields in (
                ("K2", "chain forward, stash (K2)", "chain_grad.cu",
                 "wireframe_tpu/ops/pallas_chain_grad.py:264", chain["K2"]),
                ("K3", "chain backward (K3)", "chain_grad.cu",
                 "wireframe_tpu/ops/pallas_chain_grad.py:400", chain["K3"]),
                ("K4", "lockstep JV assignment (K4)", "lockstep_lsa.cu",
                 "wireframe_tpu/ops/pallas_lsa.py:203", k4)):
            kernels.append({"name": name, "route": "cuda",
                            "source": src + source, "replaces": replaces,
                            "launches": train_launches[key], **fields,
                            "library_ms": None})
        print(json.dumps({"kernels": kernels}), flush=True)
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
