"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits nonzero and prints no final `ok` line):
  1. device   — require CUDA; print the card's name and power limit;
  2. build    — compile K1 (fused_encoder.cu), K2 + K3 + K5 (chain_grad.cu)
                and K4 (lockstep_lsa.cu) from wireframe_tpu_torch/csrc/, one
                nvcc per source, all started together; ptxas lines;
  3. K1       — against its plain PyTorch version at the recipe's full
                width (bf16 weights, kv_pool 4, tile 512) on padded and
                all-padding samples, and at a ragged shape with kv windows
                that cross the kernel's row tiles; its point features and
                kv tokens array_equal to K5's forward; K1, the plain
                version and K1's FLOP bound per shape; a profiler
                breakdown and the peak memory of one call at (3, 16384);
                the element behind K1's largest error, with the plain
                bf16 and the f32 chain's values;
  4. K4       — the lockstep JV kernel against its plain version, exactly,
                at (8, 40, 40), (6, 40, 64), (64, 40, 128) and the
                bench's (128, 40, 40) and (128, 64, 64): random
                costs, forced ties, -0.0 entries, an unclamped NaN row,
                counts 0 and R; assignment cost against scipy where the
                costs are finite; times and ns per scan step;
  5. GEMMs    — every product of the chain at (8, 2560) through the
                wgmma + TMA GEMM of csrc/hopper_gemm.cuh, alone and with
                its fused LayerNorm epilogue, against the f32 product of
                its operands and timed beside torch.matmul's bf16 product
                (a yardstick only this script calls);
  6. K2 / K3  — the stash chain forward and backward against their plain
                versions at the recipe's training shape (8, 2560), full
                width, and the bench's (128, 2560), plus small ragged
                shapes in all three flavours and a ragged shape of
                multi-CTA clusters; times, bounds and a
                profiler breakdown into fused GEMM + LayerNorm launches,
                plain GEMMs and the rest;
  7. K5       — the remat chain (non-stash forward, recomputing backward)
                against its plain versions in all three flavours, at the
                parity (3, 2560) features shape, the bench's (128, 2560),
                the recipe's (8, 2560) slim shape and small ragged shapes; its forward
                array_equal to K2's; times and bounds;
  8. training — the full-width recipe train step (train_model, overfit
                one synthetic batch of 8 box buildings, 20 steps): finite
                losses, K2 / K3 / K4 launched once per step each; the first
                3 losses against the same steps with the plain versions on
                the card; 3 steps with chain_backward=remat (K5 in place of
                K2 / K3, the same first losses); a 30-step constant-LR run
                whose loss falls, and the same 30 steps from the init's
                FFN output kernels at the scale before ROADMAP C4's repair,
                both continued to 100 steps (live slots counted after 30
                and 100, ROADMAP C1); ms per step, clouds/s, a torch.profiler
                breakdown of one step and a step under CUDA sync debug
                mode; the trained weights saved through the bridge and
                served;
  9. parity   — the reference-parity model (configs/default.yaml with the
                fused bf16 encoder: MLP vertex head, remat chain, matcher
                "device") trained 20 steps at batch 3 x 2560: K5 forward,
                K5 backward and K4 once per step, K2 / K3 never; the first
                3 losses against the plain versions; a falling loss; the
                checkpoint of epoch 10 resumed twice to the same losses;
                the memory the forward leaves for the backward, remat
                against stash; ms per step, profile, no host sync; the
                trained checkpoint served over all four buckets with K1;
 10. serving  — the full-width recipe WireframePredictor (random weights
                from a numpy seed, carried over through the flax bridge)
                serves synthetic .xyz clouds across all four point
                buckets; the K1 launch count must equal the batches
                served; .obj files must load back; one batch is compared
                between the kernel and the plain encoder chain; serving
                time per bucket, and a torch.profiler breakdown of one
                batch per bucket (device busy share, K1 against the rest);
 11. corpus   — the recipe at full width from a generated Building3D
                corpus (24 train / 8 test buildings) through the CLIs:
                `main` trains 2 epochs (K2, K3, K4 once per optimizer
                step, finite losses, step_6 and ema/step_6), `--resume` of
                the finished run leaves every file byte-identical, two
                resumes from step_3 give the same losses bit for bit with
                the restored EMA equal to the restored params; `evaluate`
                of ema/ over the plain, device-Hausdorff, pipelined and
                raw-points paths (K1 once per forward batch, pipelined
                counters equal to device Hausdorff's, finite metrics; the
                pipelined step's kept pairs in pair-table order); `test`
                writes 8 world-frame .obj files; ms per step, clouds/s per
                path and the host share of a pipelined chunk;
 12. layouts  — the full-width recipe's decoder in the layouts the JAX
                package builds besides the unrolled one: fused cross K/V,
                scanned, scanned + fused and remat, each from
                `init_flax_params` for its own tree: served over all four
                buckets (K1 once per batch, .obj files load back), trained
                5 steps at batch 8 x 2560 (K2, K3, K4 once per step; the
                first 3 losses against the plain versions); the scanned
                decoders from the unrolled weights restacked against the
                unrolled ones (served outputs and first losses); remat's
                loss and gradients against no remat with the decoder's
                dropout on, and the bytes autograd saves; ms per step and
                device ops per step (tools/trace_ops) per layout beside
                the unrolled layout's;
 13. checkpoints — a state_dict in the reference's own layout (its
                widths, 64 slots) `torch.save`d and evaluated through
                `evaluate --torch-checkpoint` on the corpus's test split in
                f32 (the plain encoder) and in bf16 through K1 (once per
                forward batch): finite metrics, the two runs' vertices
                within MODEL_ATOL; a scanned + fused recipe checkpoint
                with its Adam state resumed twice to the same losses;
 14. bench    — `wireframe_tpu_torch.bench`Then a `kernels` JSON line (launches on the main paths, on the corpus,
layouts, checkpoints and bench paths) and, last, the `ok` JSON line.

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
# The largest differences of K2, K3 and K5 from their plain versions as
# PERF.md records them for the chain kernels' current code: same seeds, no
# atomics, so a run that changes one has changed a chain kernel.
CHAIN_MAX_ABS = {"K2": 0.009540557861328125, "K3": 0.18243789672851562,
                     "K5 forward": 0.0073601603507995605,
                     "K5 backward": 0.8877887725830078}
# K1's peak device memory for one call at (3, 16384), beyond what was
# allocated before it: the two widest bf16 activations (302 MB) and the
# kv tokens, with no f32 z and no f32 features.
K1_PEAK_BYTES = 0.35e9
RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "configs", "recommended.yaml")
PARITY = os.path.join(os.path.dirname(RECIPE), "default.yaml")
# The reference-parity model as QUALITY.md's bf16 ablation runs it.
PARITY_SET = ["model.use_pallas_encoder=true", "model.compute_dtype=bfloat16"]
# The init seed of the served random recipe models (serving, layouts) and
# of the corpus run: the first seed whose random decoder keeps every
# slot live (existence above the model's 0.5) on box buildings, so that
# the decode, edge and .obj paths carry data (seed 0 keeps none).
SERVE_SEED = 1


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


def k1_equal_to_k5(torch, label, x, stages, fw, fb, p, tile):
    """K1's point features and kv tokens against K5's forward on the same
    cloud and bf16 weights: the same stage kernel and the same f32 bias
    add after the same products, so array_equal."""
    from wireframe_tpu_torch.ops.chain_grad import remat_chain_forward
    from wireframe_tpu_torch.ops.fused_encoder import fused_point_encoder

    got = fused_point_encoder(x, stages, fw, fb, tile=tile, kv_pool=p,
                              return_point_features=True,
                              compute_dtype=torch.bfloat16)
    k5 = remat_chain_forward(x, stages, fw, fb, kv_pool=p,
                             emit_features=True, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    pairs = [("point_features", "features")] + (
        [("kv_features", "pooled")] if p else [])
    same = {mine: torch.equal(got[mine], k5[theirs]) for mine, theirs in pairs}
    print(f"K1 {label} kv_pool {p}: array_equal to K5's forward {same}",
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"K1 {label} differs from K5's forward: {same}")


K1_PARTS = (("fused stage GEMM + LayerNorm", "wgmma_chain_kernel<0, 1"),
            ("projection GEMM + pools", "wgmma_chain_kernel<0, 3"),
            ("pool finalize", "k1_finalize"), ("input prep", "prep_x"))


def k1_breakdown(torch, card, label, fn):
    """Device time of one K1 call by part (torch.profiler device rows)."""
    from torch.profiler import ProfilerActivity, profile

    from wireframe_tpu_torch.utils.profiling import device_rows

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    total = sum(r[0] for r in rows)
    parts = {name: (sum(r[0] for r in rows if key in r[2]),
                    sum(r[1] for r in rows if key in r[2]))
             for name, key in K1_PARTS}
    other = total - sum(ms for ms, _ in parts.values())
    print(f"K1 {label} breakdown (profiler, one call): device {total:.3f} ms "
          f"= " + " + ".join(f"{name} {ms:.3f} ms ({n} launches)"
                             for name, (ms, n) in parts.items())
          + f" + other {other:.3f} ms [{card}]", flush=True)


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
    worst = None        # the element behind K1's largest error
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
            if err.max().item() > max_abs:
                at = np.unravel_index(int(err.argmax()), tuple(err.shape))
                worst = (f"B={b} N={n} {key}", at, g[at].item(),
                         w[at].item(), f32[key][at].item())
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
        del got, want, f32
        if (b, n) == (3, 2048):
            k1_equal_to_k5(torch, f"B={b} N={n}", x, stages, fw, fb, 4, 512)
        call = lambda: fused_point_encoder(x, stages, fw, fb, **kw)  # noqa
        if (b, n) == (3, 16384):
            k1_breakdown(torch, card, f"B={b} N={n}", call)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del out
            print(f"K1 B={b} N={n} peak device memory of one call: "
                  f"{peak / 1e9:.4f} GB beyond the {base / 1e9:.4f} GB "
                  f"allocated before it (limit {K1_PEAK_BYTES / 1e9} GB) "
                  f"[{card}]", flush=True)
            if peak > K1_PEAK_BYTES:
                raise AssertionError(f"K1 holds {peak} bytes")
        ms = cuda_ms(torch, call, 10)
        plain_ms = cuda_ms(torch, lambda: fused_point_encoder_plain(
            x, stages, fw, fb, **kw), 3)
        bound, bound_by = k1_bound_ms(b, n, 8, hidden, fw.shape[1], 4)
        timing[(b, n)] = (ms, plain_ms, bound, bound_by)
        print(f"K1 time B={b} N={n}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}), "
              f"{bound / ms * 100:.1f}% of bound [{card}]", flush=True)
        del x
    # Which side moves at K1's largest error: the kernel, or the plain
    # bf16 chain, each against the f32 chain on the same element.
    where, at, kv, pv, fv = worst
    print(f"K1 largest error {max_abs!r} at {where} index "
          f"{tuple(int(i) for i in at)}: K1 {kv!r}, plain bf16 {pv!r}, "
          f"f32 chain {fv!r}; |K1 - f32| {abs(kv - fv):.6e}, |plain - f32| "
          f"{abs(pv - fv):.6e}", flush=True)
    # Ragged edges the recipe never hits: M = B*N, widths and the output
    # not multiples of the GEMM tiles, K not a multiple of 64, a second
    # row tile of 72 rows a cloud, the call without kv tokens, and kv
    # windows of 5 and 200 rows that cross the 128-row tiles (merged from
    # edge partials; the encoder routes both at tile 200).
    small_stages, small_fw, small_fb = recipe_encoder_params(
        torch, rng, dev, hidden=(40, 72), out=36)
    x = torch.tensor(padded_clouds(rng, 2, 200), device=dev)
    for kv_pool in (4, 0, 5, 200):
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
        for key in ("masked_mean", "masked_max") + (
                ("kv_features",) if kv_pool else ()):
            if got[key][-1].abs().max().item() != 0.0:
                raise AssertionError(f"all-padding sample {key} != 0")
        k1_equal_to_k5(torch, "ragged B=2 N=200", x, small_stages, small_fw,
                       small_fb, kv_pool, 200)
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
    flax_params = init_flax_params(cfg.model, seed=SERVE_SEED)
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


# K1's device kernels in a served batch (the chain kernels do not run
# there): the wgmma GEMM's stages and projection, the prep and finalize.
K1_KERNELS = ("wgmma_chain_kernel", "prep_x_kernel", "k1_finalize_kernel")


def profile_batch(torch, predictor, chunk, bucket, card):
    """Where one served batch's time goes: device time by kernel from
    torch.profiler, against the host wall clock of the same predict()."""
    from torch.profiler import ProfilerActivity, profile

    from wireframe_tpu_torch.utils.profiling import device_rows

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
    if not k1_ms > 0:
        raise AssertionError(f"the profile of bucket {bucket} shows no K1 "
                             f"kernel among {[r[2] for r in rows]}")


# ---------------------------------------------------------------------------
# K4: the lockstep JV matcher
# ---------------------------------------------------------------------------

def k4_cases(rng):
    """(name, cost, counts, finite) cases of K4's phase: random costs and
    forced ties at the recipe's C = 40, the parity model's 64 and 128;
    -0.0 among exact zeros; an unclamped NaN row in every sample (the
    one-hot reads of the TPU body spread it over the row's columns);
    counts 0 and R."""
    cases = []
    for b, r, c in ((8, 40, 40), (6, 40, 64), (64, 40, 128), (128, 40, 40),
                    (128, 64, 64)):
        counts = rng.integers(4, 39, size=b).astype(np.int32)
        cases.append((f"random ({b}, {r}, {c})",
                      (rng.random((b, r, c)) * 10).astype(np.float32),
                      counts, True))
        cases.append((f"ties ({b}, {r}, {c})",
                      (rng.integers(0, 4, (b, r, c)) * 0.5).astype(
                          np.float32), counts, True))
    zeros = (rng.integers(0, 3, (8, 40, 40)) * 0.5).astype(np.float32)
    zeros[(zeros == 0) & (rng.random(zeros.shape) < 0.5)] = -0.0
    cases.append(("-0.0 entries (8, 40, 40)", zeros,
                  rng.integers(4, 39, size=8).astype(np.int32), True))
    nan = (rng.random((8, 40, 40)) * 10).astype(np.float32)
    nan[np.arange(8), rng.integers(0, 40, size=8)] = np.nan
    cases.append(("NaN row (8, 40, 40)", nan,
                  rng.integers(4, 39, size=8).astype(np.int32), False))
    cases.append(("counts 0 and R (8, 40, 64)",
                  (rng.random((8, 40, 64)) * 10).astype(np.float32),
                  np.array([0, 40, 0, 40, 40, 0, 40, 40], np.int32), True))
    return cases


def k4_phase(torch, dev, card):
    """K4 against its plain version (exact) and, where the costs are
    finite, scipy (cost within 1e-5); times at the recipe's (8, 40, 40).
    Returns the JSON fields."""
    from scipy.optimize import linear_sum_assignment

    from wireframe_tpu_torch.ops.lockstep_lsa import (
        solve_lsa_rows,
        solve_lsa_rows_lockstep_plain,
    )

    cases = k4_cases(np.random.default_rng(4))
    for name, cost, counts, finite in cases:
        ct = torch.tensor(cost, device=dev)
        nt = torch.tensor(counts, device=dev)
        got = solve_lsa_rows(ct, nt)
        want = solve_lsa_rows_lockstep_plain(ct, nt)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        g = got.cpu().numpy()
        worst = 0.0
        for i, k in enumerate(counts if finite else ()):
            rows, cols = linear_sum_assignment(cost[i, :k])
            best = cost[i, rows, cols].sum()
            have = cost[i, np.arange(k), g[i, :k]].sum()
            if len(set(g[i, :k].tolist())) != k or (g[i, k:] != -1).any():
                raise AssertionError(f"K4 {name}: sample {i} not an "
                                     "assignment")
            worst = max(worst, abs(have - best) / max(abs(best), 1e-12))
        print(f"K4 {name}: array_equal to plain {equal}; worst relative "
              f"cost gap to scipy "
              f"{f'{worst:.2e} (limit 1e-5)' if finite else 'not checked'}",
              flush=True)
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
    longest = int(steps.max())
    ops = total_steps * 40 * 9
    nbytes = cost.nbytes + counts.nbytes + 8 * 40 * 4
    t_ops = ops / H100_F32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(f"K4 time (8, 40, 40): kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          f"ms, {total_steps} scan steps (longest sample {longest}): "
          f"{ms * 1e6 / longest:.1f} ns per scan step of the longest "
          f"sample; bound {bound:.2e} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}); the "
          f"kernel is latency-bound by its sequential scan [{card}]",
          flush=True)
    return {"shape": "B=8 R=40 C=40", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": 0.0, "ns_per_scan_step": ms * 1e6 / longest}


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


def forward_close(label, got, want, keys):
    """Hold each output of a chain forward to its plain version with K1's
    tolerances; returns the largest absolute difference."""
    max_abs = 0.0
    for key in keys:
        g, w = got[key], want[key]
        err = (g - w).abs()
        ok = bool((err <= K1_ATOL + K1_RTOL * w.abs()).all()) and (
            err.mean().item() <= K1_MEAN_ATOL)
        max_abs = max(max_abs, err.max().item())
        print(f"{label} {key:8s} max_abs {err.max().item():.3e} mean_abs "
              f"{err.mean().item():.3e} (K1's atol {K1_ATOL}, rtol "
              f"{K1_RTOL}, mean {K1_MEAN_ATOL}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"{label} {key} disagrees")
    return max_abs


def grad_errors(gk, gp):
    """(worst max rel, its label, worst mean rel, its label, max abs) over
    dx and every parameter gradient of two chain backward results."""
    flat = lambda r: [("dx", r[0])] + [  # noqa: E731
        (f"{t}{i}", v) for i, st in enumerate(r[1])
        for t, v in zip(("dW", "db", "dgamma", "dbeta"), st)] + [
        ("dW_proj", r[2]), ("db_proj", r[3])]
    worst = [0.0, "", 0.0, "", 0.0]
    for (label, a), (_, w) in zip(flat(gk), flat(gp)):
        err = (a - w).abs()
        rel_max = (err.max() / w.abs().max().clamp_min(1e-30)).item()
        rel_mean = (err.mean() / w.abs().mean().clamp_min(1e-30)).item()
        if rel_max > worst[0]:
            worst[:2] = rel_max, label
        if rel_mean > worst[2]:
            worst[2:4] = rel_mean, label
        worst[4] = max(worst[4], err.max().item())
    return worst




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
    ("ragged features", 2, 256, (40, 72), 36, 0, True),
    # Multi-CTA clusters with a partial last CTA (600 = 2.3 x 256, 1100 =
    # 4.3 x 256), a projection of two partial tiles and M = 656, not a
    # multiple of the 128-row tile.
    ("ragged cluster", 2, 328, (600, 1100), 300, 4, True),
    # The bench's train step: 81920 kv windows, more than a grid's y
    # dimension holds (the window pool puts them on x).
    ("bench train", 128, 2560, (512, 1024, 2048, 1024), 512, 4, False))

CHAIN_FUSED = ("wgmma_chain_kernel<0, 1", "wgmma_chain_kernel<1, 2")


def chain_breakdown(torch, card, label, fn):
    """Device time of one call of fn by kernel (torch.profiler device
    rows): the fused GEMM + LayerNorm launches, the plain GEMM launches
    (projection, dx, dW) and the rest (input prep, seed, column sums,
    window pool)."""
    from torch.profiler import ProfilerActivity, profile

    from wireframe_tpu_torch.utils.profiling import device_rows

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    total = sum(r[0] for r in rows)
    fused = sum(r[0] for r in rows if any(k in r[2] for k in CHAIN_FUSED))
    gemm = sum(r[0] for r in rows if "wgmma_chain_kernel" in r[2]) - fused
    print(f"{label} breakdown (profiler, one call): device {total:.3f} ms = "
          f"fused GEMM + LayerNorm {fused:.3f} ms + plain GEMMs {gemm:.3f} "
          f"ms + rest {total - fused - gemm:.3f} ms [{card}]", flush=True)
    for ms, count, name in sorted(rows, reverse=True):
        print(f"  {ms:8.3f} ms  x{count:<3d} {name[:90]}", flush=True)
    return {"device_ms": total, "fused_ms": fused, "gemm_ms": gemm,
            "rest_ms": total - fused - gemm}


def gemm_phase(torch, dev, card, b=8, n=2560, d=8, hidden=(512, 1024, 2048,
                                                            1024), out=512):
    """Every product of the chain at the recipe's training shape, timed
    alone (CUDA events, 10 launches): the wgmma GEMM with a plain f32
    store, the same GEMM with its fused LayerNorm epilogue where the chain
    fuses one (so the difference is the epilogue's cost), and
    torch.matmul's bf16 product of the same operands as a yardstick (only
    this script calls it; the port never does).  Each plain GEMM is also
    held to the f32 product of its bf16 operands (rel 1e-4: only the
    summation order differs)."""
    from wireframe_tpu_torch.ops import chain_grad as cg

    lib = cg._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    bf = torch.bfloat16
    m = b * n

    def rows(r, c, dt=bf):
        t = cg._rows(r, c, dt, dev)
        t.normal_(generator=gen)
        return t

    def vec(c):
        return torch.randn(c, device=dev, generator=gen)

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: cudaError_t {err}")

    dims = [d, *hidden, out]
    result = {"gemm_ms": 0.0, "matmul_ms": 0.0}
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        h, w, dz = rows(m, i), rows(i, o), rows(m, o)
        bias = vec(o)
        c_fwd = torch.empty(m, o, device=dev)
        c_dh = torch.empty(m, i, device=dev)
        slices = cg.split_k(m, i, o)

        def fwd():
            check(lib.k23_gemm(0, h.data_ptr(), h.stride(0), w.data_ptr(),
                               w.stride(0), bias.data_ptr(),
                               c_fwd.data_ptr(), o, m, o, i, 1, i, stream),
                  "h W")

        def dh():
            check(lib.k23_gemm(1, dz.data_ptr(), dz.stride(0), w.data_ptr(),
                               w.stride(0), None, c_dh.data_ptr(), i, m, i,
                               o, 1, o, stream), "dz W^T")

        def dw():
            return cg._gemm_tn(lib, h, dz, slices, m, i, o, stream, "h^T dz")

        cases = [("h W", fwd, lambda: torch.matmul(h, w), c_fwd,
                  lambda: h.float() @ w.float() + bias),
                 ("dz W^T", dh, lambda: torch.matmul(dz, w.t()), c_dh,
                  lambda: dz.float() @ w.float().t()),
                 ("h^T dz", dw, lambda: torch.matmul(h.t(), dz), None,
                  lambda: h.float().t() @ dz.float())]
        fused = {}
        if k < len(hidden):       # stage k's forward LayerNorm
            hk, zk = rows(m, o), rows(m, o)
            g, be = vec(o), vec(o)
            fused["h W"] = lambda: check(lib.k2_gemm_ln(
                h.data_ptr(), h.stride(0), w.data_ptr(), w.stride(0),
                bias.data_ptr(), g.data_ptr(), be.data_ptr(), hk.data_ptr(),
                hk.stride(0), zk.data_ptr(), zk.stride(0), 0, m, o, i,
                stream), "h W + LayerNorm")
        if 0 < k:                 # stage k-1's backward LayerNorm
            zi, dzi, hi = rows(m, i), rows(m, i), rows(m, i)
            gi, bi = vec(i), vec(i)
            part = torch.empty(-(-m // cg.BM), 3 * i, device=dev)
            fused["dz W^T"] = lambda: check(lib.k3_gemm_ln_bwd(
                dz.data_ptr(), dz.stride(0), w.data_ptr(), w.stride(0),
                zi.data_ptr(), zi.stride(0), 0, gi.data_ptr(), bi.data_ptr(),
                dzi.data_ptr(), dzi.stride(0), hi.data_ptr(), hi.stride(0),
                part.data_ptr(), m, i, o, stream), "dz W^T + LN backward")
        for kind, mine, yard, got, want in cases:
            out_t = mine()
            torch.cuda.synchronize()
            got = out_t if got is None else got
            ref = want()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if rel > 1e-4:
                raise AssertionError(f"GEMM {kind} ({i}, {o}): rel err {rel}")
            ms = cuda_ms(torch, mine, 10)
            lib_ms = cuda_ms(torch, yard, 10)
            shape = {"h W": (m, i, o), "dz W^T": (m, o, i),
                     "h^T dz": (i, m, o)}[kind]
            flops = 2.0 * m * i * o
            line = (f"GEMM {kind:6s} M={shape[0]} K={shape[1]} N={shape[2]}: "
                    f"wgmma {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s), "
                    f"torch.matmul bf16 {lib_ms:.4f} ms "
                    f"({flops / lib_ms / 1e9:.0f} TFLOP/s)")
            if kind in fused:
                f_ms = cuda_ms(torch, fused[kind], 10)
                line += (f"; with the fused LayerNorm "
                         f"{'forward' if kind == 'h W' else 'backward'} "
                         f"{f_ms:.4f} ms (epilogue +{f_ms - ms:.4f} ms)")
            print(f"{line}; rel err {rel:.1e} [{card}]", flush=True)
            result["gemm_ms"] += ms
            result["matmul_ms"] += lib_ms
        del h, w, dz, c_fwd, c_dh
    print(f"GEMM sum over the chain's products at ({b}, {n}): wgmma "
          f"{result['gemm_ms']:.3f} ms, torch.matmul {result['matmul_ms']:.3f}"
          f" ms [{card}]", flush=True)
    return result


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
        keys = (["pooled", "sums"] if p else []) + (["features"] if emit
                                                     else [])
        max_abs = forward_close(f"K2 {name} ({b}, {n})", got, want, keys)
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
        worst_max, max_at, worst_mean, mean_at, bwd_abs = grad_errors(gk, gp)
        ok = worst_max <= K3_MAX_REL and worst_mean <= K3_MEAN_REL
        print(f"K3 {name} ({b}, {n}): dx and {len(gk[1]) * 4 + 2} parameter "
              f"gradients, worst max rel err {worst_max:.2e} ({max_at}; "
              f"limit {K3_MAX_REL}), worst mean rel err {worst_mean:.2e} "
              f"({mean_at}; limit {K3_MEAN_REL}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"K3 disagrees ({name})")

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
                chain_breakdown(torch, card, f"{label} ({b}, {n})", fn)
            result["K2"]["max_abs_err"] = max_abs
            result["K3"]["max_abs_err"] = bwd_abs
        del x, got, want, gk, gp
    return result


# ---------------------------------------------------------------------------
# K5: the remat chain (non-stash forward + recomputing backward)
# ---------------------------------------------------------------------------

# K5's backward against its plain version.  Unlike K3's check, where the
# kernel and the plain version read one stash, each side here recomputes
# the stage activations with its own summation order, so every bf16
# rounding flip of the forward (features within 7.4e-3 of each other, the
# level of K1's and K2's checks) reaches the two backward passes
# independently and compounds over the four stages.  Each gradient tensor
# is held to 5e-2 of its largest and 1e-2 of its mean magnitude; a wrong
# row, column, stage or statistic gives O(1).  The yardstick printed
# beside it is the same comparison for the stash path end to end: K3 on
# K2's own stash against the plain version on the plain stash.
K5_MAX_REL, K5_MEAN_REL = 5e-2, 1e-2


def k5_bound_ms(b, n, d, hidden, out, kv_pool, emit, backward):
    """Least time for K5's forward or backward: bf16 tensor-core operations
    (forward 2, backward 6 FLOP per multiply-add: recompute, dW, dh)
    against the bytes each must move (no stash)."""
    dims = [d, *hidden, out]
    macs = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    m = b * n
    weights = 2 * macs + 4 * (3 * sum(hidden) + out)
    feats = 4 * m * out if emit else 0
    kv = 3 * 4 * m // kv_pool * out if kv_pool else 0
    if backward:
        flops = 6.0 * m * macs
        nbytes = 4 * m * d + weights + feats + kv + 4 * (
            macs + 3 * sum(hidden) + out) + 4 * m * d
    else:
        flops = 2.0 * m * macs
        nbytes = 4 * m * d + weights + feats + kv
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


FULL = (512, 1024, 2048, 1024)
K5_SHAPES = (
    # (name, B, N, hidden widths, output width, kv_pool, emit features)
    ("parity features", 3, 2560, FULL, 512, 0, True),
    ("recipe-remat slim", 8, 2560, FULL, 512, 4, False),
    ("ragged kv", 2, 200, (40, 72), 36, 4, True),
    ("ragged features", 2, 256, (40, 72), 36, 0, True),
    ("ragged slim", 2, 200, (40, 72), 36, 4, False),
    ("ragged cluster", 2, 328, (600, 1100), 300, 4, True),
    ("bench parity features", 128, 2560, FULL, 512, 0, True))


def k5_phase(torch, dev, card, shapes=K5_SHAPES):
    """K5's forward and backward against their plain versions in every
    flavour, K5's forward against K2's (array_equal), then both timed at
    the parity (3, 2560) and recipe (8, 2560) shapes.  Returns the JSON
    fields of the forward and the backward at the parity shape."""
    from wireframe_tpu_torch.ops.chain_grad import (
        chain_backward,
        chain_backward_plain,
        chain_forward,
        chain_forward_plain,
        remat_chain_backward,
        remat_chain_forward,
    )

    rng = np.random.default_rng(6)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    bf = torch.bfloat16
    result = {}
    for name, b, n, hidden, out, p, emit in shapes:
        stages, fw, fb = recipe_encoder_params(torch, rng, dev,
                                               hidden=hidden, out=out)
        x = torch.tensor(padded_clouds(rng, b, n), device=dev)
        kw = dict(kv_pool=p, compute_dtype=bf, emit_features=emit)
        got = remat_chain_forward(x, stages, fw, fb, **kw)
        k2 = chain_forward(x, stages, fw, fb, **kw)
        want = chain_forward_plain(x, stages, fw, fb, stash=False,
                                   **{**kw, "emit_features": True})
        torch.cuda.synchronize()
        keys = (["pooled", "sums"] if p else []) + (["features"] if emit
                                                     else [])
        fwd_abs = forward_close(f"K5 fwd {name} ({b}, {n})", got, want, keys)
        same = [k for k in got if not torch.equal(got[k], k2[k])]
        print(f"K5 fwd {name}: {sorted(got)} array_equal to K2's: "
              f"{not same}; no stash returned: {'zs' not in got}",
              flush=True)
        if same or "zs" in got:
            raise AssertionError(f"K5 forward differs from K2's in {same}")
        cot = {}
        if p:
            cot = dict(dpool=torch.randn(want["pooled"].shape, device=dev,
                                         generator=gen),
                       dsums=torch.randn(want["sums"].shape, device=dev,
                                         generator=gen) * 0.1,
                       idx=got["idx"])
        if emit:
            cot["g"] = torch.randn(want["features"].shape, device=dev,
                                   generator=gen) * 0.1
        bkw = dict(kv_pool=p, compute_dtype=bf, **cot)
        gk = remat_chain_backward(x, stages, fw, fb, **bkw)
        gp = chain_backward_plain(x, stages, fw, fb, None, **bkw)
        yard = grad_errors(
            chain_backward(x, stages, fw, fb, k2["zs"], **bkw),
            chain_backward_plain(x, stages, fw, fb, chain_forward_plain(
                x, stages, fw, fb, **kw)["zs"], **bkw))
        torch.cuda.synchronize()
        worst_max, max_at, worst_mean, mean_at, bwd_abs = grad_errors(gk, gp)
        ok = worst_max <= K5_MAX_REL and worst_mean <= K5_MEAN_REL
        print(f"K5 bwd {name} ({b}, {n}): dx and {len(gk[1]) * 4 + 2} "
              f"parameter gradients, worst max rel err {worst_max:.2e} "
              f"({max_at}; limit {K5_MAX_REL}), worst mean rel err "
              f"{worst_mean:.2e} ({mean_at}; limit {K5_MEAN_REL}) "
              f"{'ok' if ok else 'FAIL'}; yardstick K3 on K2's stash vs "
              f"plain on the plain stash: {yard[0]:.2e} ({yard[1]}), "
              f"{yard[2]:.2e} ({yard[3]})", flush=True)
        if not ok:
            raise AssertionError(f"K5 backward disagrees ({name})")

        if b * n >= 3 * 2560:
            timed = {}
            for label, fn, plain, backward in (
                    ("forward", lambda: remat_chain_forward(
                        x, stages, fw, fb, **kw),
                     lambda: chain_forward_plain(
                         x, stages, fw, fb, stash=False, **kw), False),
                    ("backward", lambda: remat_chain_backward(
                        x, stages, fw, fb, **bkw),
                     lambda: chain_backward_plain(
                         x, stages, fw, fb, None, **bkw), True)):
                ms = cuda_ms(torch, fn, 10)
                plain_ms = cuda_ms(torch, plain, 3)
                bound, bound_by = k5_bound_ms(b, n, 8, hidden, out, p, emit,
                                              backward)
                print(f"K5 {label} time {name} ({b}, {n}): kernel "
                      f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                      f"{bound:.4f} ms ({bound_by}), "
                      f"{bound / ms * 100:.1f}% of bound; library: none "
                      f"(no single PyTorch call computes it) [{card}]",
                      flush=True)
                timed[label] = {"shape": f"B={b} N={n} kv_pool={p}"
                                + ("" if emit else " slim"),
                                "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound, "bound_by": bound_by,
                                "max_abs_err": fwd_abs if label == "forward"
                                else bwd_abs}
            if name == "parity features":
                result = timed
        del x, got, want, k2, gk, gp
    return result


# ---------------------------------------------------------------------------
# Training: the recipe train step
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20
FALL_STEPS = 30
C1_STEPS = 100
# The first steps with the kernels against the same steps with the plain
# versions on the card: bf16 throughout, the two differ by K2's rounding
# flips (pooled kv within 1e-2), carried through the decoder and the loss;
# warmup makes the first update 0 and the next two tiny.
TRAIN_LOSS_RTOL = 1e-2


def _counters():
    from wireframe_tpu_torch.ops import chain_grad, fused_encoder
    from wireframe_tpu_torch.ops.lockstep_lsa import solve_lsa_rows

    return {"K1": fused_encoder.fused_point_encoder,
            "K2": chain_grad.chain_forward, "K3": chain_grad.chain_backward,
            "K4": solve_lsa_rows,
            "K5 fwd": chain_grad.remat_chain_forward,
            "K5 bwd": chain_grad.remat_chain_backward}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0


def launch_counts():
    return {k: fn.launches for k, fn in _counters().items()}


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


# Device kernel names of each kernel's launches (csrc/hopper_gemm.cuh's
# wgmma_chain_kernel<form, epilogue, f32 z>: form 0 h W, 1 dz W^T, 2 h^T dz;
# epilogue 0 store, 1 LayerNorm forward, 2 LayerNorm backward).
TRAIN_KERNELS = {
    "K2": ("wgmma_chain_kernel<0, ", "window_pool"),
    "K3": ("wgmma_chain_kernel<1, ", "wgmma_chain_kernel<2, ", "seed_kernel",
           "colsum", "prep_x"),
    "K4": ("lsa_kernel",),
}
# The remat chain runs the same kernels as K2 + K3 (LN backward on f32 z).
PARITY_KERNELS = {"K5": TRAIN_KERNELS["K2"] + TRAIN_KERNELS["K3"],
                  "K4": TRAIN_KERNELS["K4"]}


def training_phase(torch, dev, card, work):
    """Train the full-width recipe; returns the launch counts of the
    20-step main-path run."""
    from wireframe_tpu_torch.bridge import (
        save_port_checkpoint,
        state_dict_to_flax,
    )
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.io.obj import load_wireframe
    from wireframe_tpu_torch.serve import WireframePredictor
    from wireframe_tpu_torch.train.loop import (
        device_batch,
        init_model,
        train_model,
    )
    from wireframe_tpu_torch.train.state import create_train_state
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
    reset_launches()
    t0 = time.perf_counter()
    state = train_model(cfg, [batch], metric_writer=writer, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    launches = {k: counts[k] for k in ("K2", "K3", "K4")}
    losses = [r["total_loss"] for r in writer.rows]
    print(f"train {TRAIN_STEPS} steps in {secs:.2f} s, metrics read back "
          f"every step; losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}", flush=True)
    print(f"train launches over {TRAIN_STEPS} steps: {launches}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError("a training loss is not finite")
    if any(v != TRAIN_STEPS for v in launches.values()) or counts["K5 fwd"]:
        raise AssertionError(f"kernels not launched once per step: "
                             f"{counts}")

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

    # The recipe with the remat chain: K5's slim kv flavour in place of
    # K2 + K3.  K5's forward is K2's bit for bit, and warmup makes the
    # first update 0, so the first 2 losses equal the stash run's.
    remat_cfg = load_config(RECIPE, base + ["model.chain_backward=remat",
                                            "train.num_epochs=3"])
    remat_writer = _Losses()
    reset_launches()
    train_model(remat_cfg, [batch], metric_writer=remat_writer, device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    rl = [r["total_loss"] for r in remat_writer.rows]
    print(f"train recipe chain_backward=remat, 3 steps: losses {rl} vs "
          f"stash {losses[:3]}; launches {counts}", flush=True)
    if (counts["K5 fwd"], counts["K5 bwd"], counts["K4"]) != (3, 3, 3) or (
            counts["K2"] or counts["K3"]):
        raise AssertionError(f"recipe remat launches {counts}")
    rel = [abs(a - b) / abs(b) for a, b in zip(rl, losses)]
    print(f"train recipe remat vs stash: bit-identical first 2 losses "
          f"{rl[:2] == losses[:2]}, relative differences {rel} (limits "
          f"1e-6, 1e-6, {TRAIN_LOSS_RTOL})", flush=True)
    if max(rel[:2]) > 1e-6 or rel[2] > TRAIN_LOSS_RTOL:
        raise AssertionError("recipe remat losses differ from the stash's")

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

    # ROADMAP C1 and C4: the same 30 steps from the init before C4's
    # repair, the four ffn_out kernels 16x smaller (the attention output's
    # fan-in, 1024 x 256, in place of 1024); live slots counted alike.
    old_model = init_model(fall_cfg, dev)
    with torch.no_grad():
        for name, p in old_model.named_parameters():
            if name.endswith("ffn_out.weight"):
                p.div_(16.0)
    old_writer = _Losses()
    old_state = train_model(fall_cfg, [batch], metric_writer=old_writer,
                            state=create_train_state(fall_cfg, old_model),
                            device=dev)
    dbatch = device_batch(batch, dev)
    runs = {"repaired init": (fall_state, fl),
            "pre-repair ffn_out scale": (
                old_state, [r["total_loss"] for r in old_writer.rows])}

    def live_slots(steps):
        for label, (st, run) in runs.items():
            with torch.no_grad():
                probs = st.model.eval()(dbatch["point_clouds"])[
                    "existence_probabilities"]
            print(f"C1: after {steps} constant-LR steps from the {label}: "
                  f"existence > 0.5 in {int((probs > 0.5).sum())} of "
                  f"{probs.numel()} slots (8 corners a cloud, so 0.2 of "
                  f"the slots exist), mean {float(probs.mean()):.3f}, max "
                  f"{float(probs.max()):.3f}; losses first {run[0]:.5f}, "
                  f"last {run[-1]:.5f}", flush=True)

    live_slots(FALL_STEPS)
    # Both runs continued at the same LR: is an empty wireframe after 30
    # steps the existence head's prior (0.2) or a lasting state?
    long_cfg = load_config(RECIPE, base + [
        "train.lr_schedule=constant", f"train.num_epochs={C1_STEPS}"])
    for label, (st, run) in runs.items():
        writer_c = _Losses()
        train_model(long_cfg, [batch], metric_writer=writer_c, state=st,
                    start_epoch=FALL_STEPS, device=dev)
        run.extend(r["total_loss"] for r in writer_c.rows)
    live_slots(C1_STEPS)

    step_ms = time_and_check_step(torch, cfg, state, dbatch, dev, card,
                                  TRAIN_KERNELS, "train")

    # The trained weights (C1_STEPS steps), through the bridge, served.
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


# ---------------------------------------------------------------------------
# Training: the reference-parity model (remat chain K5, MLP head, K4)
# ---------------------------------------------------------------------------

PARITY_STEPS = 20
PARITY_CKPT_EPOCH = 10
STASH_BYTES = 2 * 3 * 2560 * sum(FULL)   # bf16 z_k of the stash at (3, 2560)


def held_after_loss(torch, cfg, dev, dbatch):
    """What one train-mode forward + loss leaves for the backward, the
    model's weights and the batch excluded: (bytes allocated, bytes of the
    tensors autograd saved).  The allocator's count includes its rounding
    of blocks and has moved between runs of unchanged chain code, so the
    saving is held on the second, which counts each saved storage once at
    its size."""
    from wireframe_tpu_torch.losses.wireframe_loss import wireframe_loss
    from wireframe_tpu_torch.train.loop import init_model
    from wireframe_tpu_torch.train.step import loss_config

    model = init_model(cfg, dev).train()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    kept = {t.untyped_storage().data_ptr() for t in [
        *model.parameters(), *dbatch.values()] if torch.is_tensor(t)}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in kept:
            saved[st.data_ptr()] = st.nbytes()
        return t

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        preds = model(dbatch["point_clouds"], dbatch["vertex_counts"],
                      train=True, generator=gen)
        losses = wireframe_loss(preds, {
            "vertices": dbatch["target_vertices"],
            "vertex_existence": dbatch["vertex_existence"],
            "edge_labels": dbatch["edge_labels"],
            "vertex_counts": dbatch["vertex_counts"]}, loss_config(cfg))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del preds, losses, model
    return held, sum(saved.values())


def parity_phase(torch, dev, card, work):
    """Train the full-width reference-parity model (configs/default.yaml
    with the fused bf16 encoder): K5 forward and backward and K4 once per
    step; checkpoint at epoch 10 resumed twice; remat's memory against
    the stash's; the trained checkpoint served over all four buckets with
    K1.  Returns (launch counts of the 20-step main-path run, ms/step)."""
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.bucketing import choose_bucket
    from wireframe_tpu_torch.io.obj import load_wireframe
    from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
    from wireframe_tpu_torch.serve import WireframePredictor
    from wireframe_tpu_torch.train.checkpoint import (
        latest_step,
        restore_train_state,
        save_checkpoint,
    )
    from wireframe_tpu_torch.train.loop import (
        device_batch,
        init_model,
        train_model,
    )
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.utils.synth import make_box_building_batch

    ckdir = os.path.join(work, "parity_ckpt")
    base = PARITY_SET + ["train.log_every=1",
                         f"train.checkpoint_dir={ckdir}",
                         f"train.checkpoint_every={PARITY_CKPT_EPOCH}"]
    cfg = load_config(PARITY, base + [f"train.num_epochs={PARITY_STEPS}"])
    m, t = cfg.model, cfg.train
    print(f"training parity: encoder {m.encoder_hidden_dims}->"
          f"{m.encoder_output_dim}, vertex head {m.vertex_head} "
          f"(512->4096->2048->2048->1024->{m.max_vertices}x{m.vertex_dim}), "
          f"edge head {m.edge_hidden_dim}/{m.edge_num_heads} heads over "
          f"{m.max_vertices * (m.max_vertices - 1) // 2} pairs, "
          f"{m.compute_dtype}, chain_backward {m.chain_backward}, chain "
          f"tile {m.pallas_chain_tile}, slot masks {m.slot_mask_mode}, batch "
          f"{t.batch_size} x {cfg.data.num_points} points, lr "
          f"{t.learning_rate} {t.lr_schedule}, matcher {t.matcher}, labels "
          f"{'matched' if t.matched_edge_labels else 'positional'}, "
          f"augment {t.device_augment and cfg.data.augment}, "
          f"checkpoint_every {t.checkpoint_every}", flush=True)
    batch = make_box_building_batch(cfg, t.batch_size, seed=0)

    # The main path: counts to 0, 20 steps, counts read.
    writer = _Losses()
    reset_launches()
    t0 = time.perf_counter()
    state = train_model(cfg, [batch], metric_writer=writer, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    losses = [r["total_loss"] for r in writer.rows]
    print(f"parity train {PARITY_STEPS} steps in {secs:.2f} s; launches "
          f"{counts}; losses {', '.join(f'{v:.5f}' for v in losses)}",
          flush=True)
    if len(losses) != PARITY_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError("a parity training loss is not finite")
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": PARITY_STEPS,
            "K5 fwd": PARITY_STEPS, "K5 bwd": PARITY_STEPS}
    if counts != want:
        raise AssertionError(f"parity launches {counts}, expected {want}")

    # At the reference's lr 1e-3 Adam overshoots first: on the H100 the
    # loss rose for ~8 steps and fell back below its start by step 60,
    # alike with the plain versions, the stash chain, the plain chain and
    # f32.  Show the fall at lr 1e-4 in as many steps.
    fall = ["train.learning_rate=0.0001", "train.checkpoint_every=0"]
    fall_writer = _Losses()
    train_model(load_config(PARITY, base + fall + [
        f"train.num_epochs={PARITY_STEPS}"]), [batch],
        metric_writer=fall_writer, device=dev)
    fl = [r["total_loss"] for r in fall_writer.rows]
    first, last = float(np.mean(fl[:3])), float(np.mean(fl[-3:]))
    print(f"parity {PARITY_STEPS} steps with the override {fall[0]}: mean "
          f"loss of the first 3 steps {first:.5f}, of the last 3 "
          f"{last:.5f}; losses {', '.join(f'{v:.4f}' for v in fl)}",
          flush=True)
    if not all(map(math.isfinite, fl)) or not last < first:
        raise AssertionError("the parity loss does not fall")

    # The first 3 steps, kernels against the plain versions on the card,
    # at lr 1e-6, as the recipe's warmup gives its first steps (0, 1.5e-6,
    # 3e-6).  Adam's first updates move each parameter by about +-lr, so
    # the sign flips of near-zero gradients between the two summation
    # orders, and the matchings they then flip, moved the third loss by 5%
    # at lr 1e-3 and by 4% at 1e-4 on the H100.
    tiny = ["train.learning_rate=0.000001", "train.checkpoint_every=0",
            "train.num_epochs=3"]
    runs = []
    for plain_versions in (False, True):
        w = _Losses()
        with plain_kernels() if plain_versions else contextlib.nullcontext():
            train_model(load_config(PARITY, base + tiny), [batch],
                        metric_writer=w, device=dev)
        runs.append([r["total_loss"] for r in w.rows])
    rel = [abs(a - b) / abs(b) for a, b in zip(*runs)]
    print(f"parity first 3 losses at lr 1e-6, kernels {runs[0]} vs plain "
          f"versions {runs[1]}: max rel diff {max(rel):.2e} (rtol "
          f"{TRAIN_LOSS_RTOL})", flush=True)
    if max(rel) > TRAIN_LOSS_RTOL:
        raise AssertionError("parity losses differ from the plain run")

    # The checkpoint written at epoch 10, resumed twice.
    if latest_step(ckdir) != PARITY_CKPT_EPOCH:
        raise AssertionError(f"checkpoints under {ckdir}: "
                             f"{sorted(os.listdir(ckdir))}")
    runs = []
    for _ in range(2):
        fresh = create_train_state(cfg, init_model(cfg, dev, seed=7))
        fresh, start = restore_train_state(fresh, ckdir)
        w = _Losses()
        train_model(cfg, [batch], metric_writer=w, state=fresh,
                    start_epoch=start, device=dev)
        runs.append([r["total_loss"] for r in w.rows])
    rel = max(abs(a - b) / abs(b) for a, b in zip(*runs))
    print(f"parity resume from step {start} (epoch {start}), twice: "
          f"{len(runs[0])} losses each, bit-identical {runs[0] == runs[1]}, "
          f"max rel diff {rel:.2e} (limit 1e-5); continuous run "
          f"{losses[start:]}, resumed {runs[0]}", flush=True)
    if len(runs[0]) != PARITY_STEPS - PARITY_CKPT_EPOCH or rel > 1e-5:
        raise AssertionError("two resumes from one checkpoint differ")

    # What the forward leaves for the backward: remat holds no stash.
    dbatch = device_batch(batch, dev)
    held = {mode: held_after_loss(torch, load_config(PARITY, base + [
        f"model.chain_backward={mode}"]), dev, dbatch)
        for mode in ("remat", "stash")}
    alloc = held["stash"][0] - held["remat"][0]
    saved = held["stash"][1] - held["remat"][1]
    print(f"parity memory held between forward and backward: allocated "
          f"remat {held['remat'][0] / 1e6:.1f} MB, stash "
          f"{held['stash'][0] / 1e6:.1f} MB (remat {alloc / 1e6:.2f} MB "
          f"less); saved for the backward remat "
          f"{held['remat'][1] / 1e6:.2f} MB, stash "
          f"{held['stash'][1] / 1e6:.2f} MB: remat saves "
          f"{saved / 1e6:.2f} MB (the stash is {STASH_BYTES / 1e6:.2f} MB) "
          f"[{card}]", flush=True)
    if saved < STASH_BYTES:
        raise AssertionError("remat does not save the stash's memory")

    step_ms = time_and_check_step(torch, cfg, state, dbatch, dev, card,
                                  PARITY_KERNELS, "parity")

    # The trained checkpoint, served with K1 over all four buckets.
    path = save_checkpoint(ckdir, state, cfg, epoch=PARITY_STEPS)
    predictor = WireframePredictor(path, device=dev)
    sizes = (1300, 3000, 6000, 12000, 20000)
    rng = np.random.default_rng(8)
    offset = np.array([534000.0, 6588000.0, 40.0])
    paths = []
    for i, n in enumerate(sizes):
        pth = os.path.join(work, f"parity_cloud{i}_{n}.xyz")
        np.savetxt(pth, synthetic_building(rng, n, offset), fmt="%.4f")
        paths.append(pth)
    buckets = [choose_bucket(n, predictor.buckets) for n in sizes]
    if sorted(set(buckets)) != sorted(predictor.buckets):
        raise AssertionError(f"parity clouds miss a bucket: {buckets}")
    batches = sum(-(-buckets.count(k) // predictor.batch_size)
                  for k in set(buckets))
    reset_launches()
    results = predictor.predict_files(paths, out_dir=os.path.join(
        work, "parity_obj"))
    k1 = launch_counts()["K1"]
    for pth, r in zip(paths, results):
        v, e = r["vertices"], r["edges"]
        lv, le = load_wireframe(r["obj_path"])
        if not np.isfinite(v).all() or lv.shape != v.shape or (
                len(le) != r["num_edges"]) or (
                len(e) and e.max() >= r["num_vertices"]):
            raise AssertionError(f"parity checkpoint: {pth} does not serve")
        if len(v) and np.linalg.norm(v.mean(0) - offset) > 100.0:
            raise AssertionError(f"vertices of {pth} not in world frame")
        print(f"served parity checkpoint: {os.path.basename(pth)} -> "
              f"{r['num_vertices']} vertices, {r['num_edges']} edges",
              flush=True)
    print(f"parity serving: {len(paths)} clouds in {batches} batches over "
          f"buckets {predictor.buckets}; K1 launches {k1}", flush=True)
    if k1 != batches:
        raise AssertionError(f"K1 launched {k1} times for {batches} batches")

    # Kernel encoder against the plain chain on one served batch.  The
    # trained model's vertices leave the unit sphere (the lr 1e-3
    # overshoot), where one bf16 ulp exceeds the unit-frame atol: each
    # output is held to its atol plus 2e-2 (~5 bf16 ulps) of its size.
    pcs = [predictor._preprocess(np.loadtxt(pth))["pc"] for pth in paths[:2]]
    xb = torch.tensor(predictor.batch_array(pcs, predictor.buckets[1]),
                      device=dev)
    plain_cfg = load_config(PARITY, [*base,
                                     "model.use_pallas_encoder=false"])
    plain_model = PointCloudToWireframe(plain_cfg.model).to(dev).eval()
    plain_model.load_state_dict(predictor.model.state_dict(), strict=True)
    with torch.inference_mode():
        out_k = predictor.model(xb)
        out_p = plain_model(xb)
    for key, atol in MODEL_ATOL.items():
        diff = (out_k[key] - out_p[key]).abs()
        ok = bool((diff <= atol + 2e-2 * out_p[key].abs()).all())
        print(f"parity model kernel vs plain chain: {key} max_abs "
              f"{diff.max().item():.3e} where the largest |value| is "
              f"{out_p[key].abs().max().item():.3f} (atol {atol}, rtol "
              f"2e-2) {'ok' if ok else 'FAIL'}", flush=True)
        if not torch.isfinite(out_k[key]).all() or not ok:
            raise AssertionError(f"parity model {key} disagrees")
    return counts, step_ms


def time_and_check_step(torch, cfg, state, dbatch, dev, card, kernels,
                        label):
    """ms per step (the step alone, no metric read-back, after warm-up),
    a profile of one step, and one step under CUDA's sync debug mode,
    which must flag no synchronizing operation.  Returns ms per step."""
    from wireframe_tpu_torch.train.step import make_train_step

    step = make_train_step(cfg)
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
    b, n = dbatch["point_clouds"].shape[:2]
    print(f"{label} step: {step_ms:.2f} ms/step, {b / step_ms * 1e3:.1f} "
          f"training clouds/s (batch {b} x {n} points, host clock over "
          f"{n_timed} steps ending in a synchronize) [{card}]", flush=True)
    profile_train_step(torch, step, state, dbatch, gen, card, kernels, label)

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
    print(f"{label} step under CUDA sync debug mode: {len(syncs)} "
          f"synchronizing operations", flush=True)
    for w in syncs[:10]:
        print(f"  {w.filename}:{w.lineno}: {str(w.message)[:80]}",
              flush=True)
    if syncs:
        raise AssertionError(f"the {label} step synchronizes with the host")
    return step_ms


def profile_train_step(torch, step, state, batch, gen, card, kernels,
                       label):
    """Where one train step's time goes: device time by kernel from
    torch.profiler against the host wall clock of the same step."""
    from torch.profiler import ProfilerActivity, profile

    from wireframe_tpu_torch.utils.profiling import device_rows

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows)
    per = {k: sum(r[0] for r in rows if any(s in r[2] for s in subs))
           for k, subs in kernels.items()}
    rest = device_ms - sum(per.values())
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in per.items())
    print(f"profile {label} step: wall {wall_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms ({device_ms / wall_ms * 100:.1f}%), {parts}, "
          f"rest of the step {rest:.2f} ms, "
          f"{sum(r[1] for r in rows)} device ops [{card}]", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:10]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}", flush=True)


# ---------------------------------------------------------------------------
# Corpus: train and evaluate from a Building3D corpus through the CLIs
# ---------------------------------------------------------------------------

CORPUS = ["--train", "24", "--test", "8", "--seed", "0", "--mix", "real"]
CORPUS_EPOCHS = 2
CORPUS_STEPS = CORPUS_EPOCHS * (24 // 8)      # batch 8, drop_last


def _sets(overrides):
    return [a for o in overrides for a in ("--set", o)]


def _tree_digest(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _losses(ckdir):
    with open(os.path.join(ckdir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _eval_thresholds(torch, cfg, params, dataset, dev):
    """Vertex and edge thresholds at which the decode of this barely
    trained model keeps work for every stage of the eval paths: the
    median existence probability (about half the slots live) and the
    90th percentile of the live pairs' edge probabilities; each rounded
    to float32, so the host's and the card's comparisons agree."""
    from wireframe_tpu_torch.data.building3d import collate_fixed
    from wireframe_tpu_torch.eval.evaluator import make_forward_fn
    from wireframe_tpu_torch.ops.pairs import triu_pairs_np

    samples = [dataset.get_sample(i, rng=np.random.default_rng(
        (cfg.data.seed, i)), augment_on_host=False)
        for i in range(len(dataset))]
    out = make_forward_fn(cfg, params, dev)(
        collate_fixed(samples, cfg.model.max_vertices)["point_clouds"])
    exist = out["existence_probabilities"]
    vthresh = float(np.float32(np.median(exist)))
    live = exist > vthresh
    pairs = triu_pairs_np(cfg.model.max_vertices)
    both = live[:, pairs[:, 0]] & live[:, pairs[:, 1]]
    ethresh = float(np.float32(np.quantile(out["edge_probs"][both], 0.9)))
    return vthresh, ethresh


def corpus_phase(torch, dev, card, work):
    """The recipe at full width from a generated corpus through the CLIs:
    train (main), resume, evaluate over four paths, write .obj (test).
    Returns {kernel: launches on this path}."""
    import dataclasses
    import io

    from wireframe_tpu_torch import evaluate as evaluate_cli
    from wireframe_tpu_torch import main as main_cli
    from wireframe_tpu_torch import test as test_cli
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.bucketing import choose_bucket
    from wireframe_tpu_torch.data.building3d import Building3DDataset
    from wireframe_tpu_torch.eval.pipeline import (
        _build_chunk,
        evaluate_corpus_pipelined,
        make_eval_step,
    )
    from wireframe_tpu_torch.eval.evaluator import build_model
    from wireframe_tpu_torch.io.obj import load_wireframe
    from wireframe_tpu_torch.metrics.ap_calculator import _COUNTER_KEYS
    from wireframe_tpu_torch.ops.pairs import triu_pairs_np
    from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main
    from wireframe_tpu_torch.train.checkpoint import (
        load_checkpoint,
        restore_train_state,
    )
    from wireframe_tpu_torch.train.loop import init_model
    from wireframe_tpu_torch.train.state import create_train_state

    root = os.path.join(work, "corpus")
    t0 = time.perf_counter()
    gen_main(["--out", root, *CORPUS])
    print(f"corpus: generated {' '.join(CORPUS)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # Train seed SERVE_SEED, whose random decoder keeps the slots live,
    # so that the edge head, the decode and the Hausdorff passes carry
    # data; after 6 steps of warmup from lr 0 the weights are still close
    # to their init.
    overrides = [f"train.num_epochs={CORPUS_EPOCHS}",
                 "train.checkpoint_every=1", "train.log_every=1",
                 f"train.seed={SERVE_SEED}", f"data.root_dir={root}"]
    ck = os.path.join(work, "corpus_ckpt")

    def train_argv(ckdir):
        return (["--config", RECIPE, "--data-root", root, "--checkpoint-dir",
                 ckdir, "--device", str(dev)] + _sets(overrides))

    # The main path: counts to 0, the training CLI, counts read.
    reset_launches()
    t0 = time.perf_counter()
    main_cli.main(train_argv(ck))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    train_counts = launch_counts()
    rows = _losses(ck)
    losses = [r["total_loss"] for r in rows]
    print(f"corpus train CLI: {CORPUS_STEPS} optimizer steps in {secs:.2f} s "
          f"(corpus parse, model init, checkpoints included); losses "
          f"{losses}; launches {train_counts}", flush=True)
    if len(losses) != CORPUS_EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError("corpus training losses missing or not finite")
    want = {"K1": 0, "K2": CORPUS_STEPS, "K3": CORPUS_STEPS,
            "K4": CORPUS_STEPS, "K5 fwd": 0, "K5 bwd": 0}
    if train_counts != want:
        raise AssertionError(f"corpus launches {train_counts}, expected "
                             f"{want}")
    for name in (f"step_{CORPUS_STEPS}", f"ema/step_{CORPUS_STEPS}",
                 "step_3"):
        if not os.path.isdir(os.path.join(ck, name)):
            raise AssertionError(f"{name} missing under {sorted(os.listdir(ck))}")
    # The second epoch: host clock between the two log points (each reads
    # the metrics back), which also holds the step_3 checkpoint write.
    epoch_ms = (rows[1]["elapsed_time"] - rows[0]["elapsed_time"]) / (
        CORPUS_STEPS // CORPUS_EPOCHS) * 1e3
    print(f"corpus train CLI: {epoch_ms:.2f} ms per step over epoch 2 "
          f"(batch 8 x 2560 points, loader prefetch and the step_3 "
          f"checkpoint write included), {secs / CORPUS_STEPS * 1e3:.1f} ms "
          f"per step over the whole CLI run [{card}]", flush=True)

    # --resume on the finished run changes nothing.
    before = _tree_digest(ck)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_cli.main(train_argv(ck) + ["--resume"])
    said = buf.getvalue()
    print(said.rstrip(), flush=True)
    same = _tree_digest(ck) == before
    print(f"corpus resume of the finished run: files byte-identical {same}",
          flush=True)
    if "training already complete at epoch 2" not in said or not same:
        raise AssertionError("--resume of a finished run touched files")

    # Two resumes from the epoch-1 checkpoint into fresh directories.
    cfg = load_config(RECIPE, overrides)
    resumed = []
    for r in range(2):
        d = os.path.join(work, f"corpus_resume{r}")
        os.makedirs(d)
        shutil.copytree(os.path.join(ck, "step_3"), os.path.join(d, "step_3"))
        shutil.copy(os.path.join(ck, "step_3.meta.json"), d)
        if r == 0:
            fresh = create_train_state(cfg, init_model(cfg, dev, seed=7))
            fresh, start = restore_train_state(fresh, d)
            ema_eq = all(torch.equal(fresh.ema_params[k], p)
                         for k, p in fresh.params.items())
            print(f"corpus restore of step_3: epoch {start}, step "
                  f"{fresh.step}, EMA equal to the restored params "
                  f"{ema_eq}", flush=True)
            if not ema_eq or (start, fresh.step) != (1, 3):
                raise AssertionError("the restored EMA is not the params")
            del fresh
        main_cli.main(train_argv(d) + ["--resume"])
        rows_r = _losses(d)
        resumed.append([row["total_loss"] for row in rows_r])
        # No checkpoint inside a resumed epoch 2: train_model's host clock
        # from its start to the log point over the epoch's 3 steps.
        step_ms = rows_r[-1]["elapsed_time"] / (
            CORPUS_STEPS // CORPUS_EPOCHS) * 1e3
        print(f"corpus resumed epoch 2: {step_ms:.2f} ms per step (batch 8 "
              f"x 2560 points, loader prefetch and the first step's "
              f"allocations included, no checkpoint write) [{card}]",
              flush=True)
    print(f"corpus resumes from step_3, twice: epoch-2 losses {resumed}, "
          f"bit-identical {resumed[0] == resumed[1]}; uninterrupted run "
          f"{losses[1:]} (the draws are seeded from (seed, start_epoch))",
          flush=True)
    if resumed[0] != resumed[1] or len(resumed[0]) != 1:
        raise AssertionError("two resumes from one checkpoint differ")

    # Evaluation of <ckpt>/ema over the test split, four paths.  One
    # forward batch of 8 everywhere, so the pipelined and device-Hausdorff
    # counters come from the same forward.
    ema = os.path.join(ck, "ema")
    payload, meta = load_checkpoint(ema)
    test_ds = Building3DDataset(cfg.data, "test")
    vthresh, ethresh = _eval_thresholds(torch, cfg, payload["params"],
                                        test_ds, dev)
    eval_sets = [f"eval.vertex_existence_thresh={vthresh!r}",
                 f"eval.edge_confidence_thresh={ethresh!r}"]
    print(f"corpus eval thresholds: vertex {vthresh!r}, edge {ethresh!r}",
          flush=True)
    base = ["--config", RECIPE, "--data-root", root, "--checkpoint-dir", ema,
            "--device", str(dev)]
    raw_ds = Building3DDataset(dataclasses.replace(cfg.data, num_points=0),
                               "test")
    raw_sizes = [raw_ds.get_sample(i, augment_on_host=False)[
        "point_clouds"].shape[0] for i in range(len(raw_ds))]
    raw_batches = len({choose_bucket(n, cfg.data.point_buckets)
                       for n in raw_sizes})
    paths = {"plain": ([], 1), "device Hausdorff": (["--device-hausdorff"], 1),
             "pipelined": (["--pipelined", "--eval-batch", "8"], 1),
             "raw points": (["--raw-points"], raw_batches)}
    aps, k1 = {}, 0
    for label, (extra, batches) in paths.items():
        reset_launches()
        t0 = time.perf_counter()
        aps[label] = evaluate_cli.run(
            base + _sets(eval_sets + ["eval.batch_size=8"]) + extra)
        secs = time.perf_counter() - t0
        n = launch_counts()["K1"]
        k1 += n
        m = aps[label].summarize()
        print(f"corpus evaluate {label}: K1 launches {n} for {batches} "
              f"forward batches; {len(test_ds) / secs:.2f} clouds/s (CLI "
              f"wall {secs:.2f} s over {len(test_ds)} clouds: checkpoint, "
              f"parse, forward, metrics) [{card}]; counters "
              f"{ {k: aps[label].ap_dict[k] for k in _COUNTER_KEYS} }",
              flush=True)
        if n != batches:
            raise AssertionError(f"evaluate {label}: {n} K1 launches")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"evaluate {label}: non-finite metrics {m}")
    counters = {label: [float(ap.ap_dict[k]) for k in _COUNTER_KEYS]
                + [ap.num_samples] for label, ap in aps.items()}
    print(f"corpus pipelined counters equal to device Hausdorff's: "
          f"{counters['pipelined'] == counters['device Hausdorff']}; plain "
          f"(f64 host Hausdorff) minus device: "
          f"{np.subtract(counters['plain'], counters['device Hausdorff']).tolist()}",
          flush=True)
    if counters["pipelined"] != counters["device Hausdorff"]:
        raise AssertionError("pipelined counters differ from device "
                             "Hausdorff's")
    if aps["pipelined"].ap_dict["tp_fp_edges"] == 0:
        raise AssertionError("the eval kept no predicted edge")
    # Not asserted: the forward at another batch (eval.batch_size 3).
    ap3 = evaluate_cli.run(base + _sets(eval_sets) + ["--device-hausdorff"])
    print(f"corpus device Hausdorff at eval.batch_size 3 equal to batch 8: "
          f"{[float(ap3.ap_dict[k]) for k in _COUNTER_KEYS] == counters['device Hausdorff'][:-1]}",
          flush=True)

    # The pipelined step on the card: the stable sort keeps the kept
    # pairs in pair-table order; the host share of a chunk.
    cfg_e = load_config(RECIPE, overrides + eval_sets)
    model = build_model(cfg_e, payload["params"], dev)
    step = make_eval_step(cfg_e, 128, 64, 8)
    _, clouds, gt_ev, _, _ = _build_chunk(cfg_e, test_ds, list(range(8)), 8,
                                          64)
    out = step(model, torch.from_numpy(clouds).to(dev),
               torch.from_numpy(gt_ev).to(dev))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    pairs = triu_pairs_np(cfg_e.model.max_vertices)
    ordered = 0
    for j in range(8):
        live = out["existence"][j] > vthresh
        keep = (live[pairs[:, 0]] & live[pairs[:, 1]]
                & (out["edge_probs"][j] > ethresh))
        want_sel = np.flatnonzero(keep)[:128]
        if not np.array_equal(out["sel"][j][:len(want_sel)], want_sel):
            raise AssertionError(f"sample {j}: kept pairs out of order")
        ordered += len(want_sel)
    print(f"corpus pipelined step: the {ordered} kept pairs of the chunk in "
          f"pair-table order (stable sort on the card)", flush=True)
    from torch.profiler import ProfilerActivity, profile

    from wireframe_tpu_torch.utils.profiling import device_rows

    evaluate_corpus_pipelined(cfg_e, payload["params"], test_ds, batch=8,
                              device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_corpus_pipelined(cfg_e, payload["params"], test_ds,
                                  batch=8, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(r[0] for r in device_rows(prof))
    print(f"corpus pipelined chunk of 8 (parsed corpus, model build "
          f"included): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
          f"host share {(1 - busy / wall_ms) * 100:.1f}% [{card}]",
          flush=True)

    # Inference .obj files in world coordinates.
    out_dir = os.path.join(work, "corpus_pred")
    reset_launches()
    test_cli.main(base + _sets(eval_sets + ["eval.batch_size=8"])
                  + ["--out-dir", out_dir])
    n = launch_counts()["K1"]
    k1 += n
    objs = sorted(os.listdir(out_dir))
    verts_total = 0
    for name in objs:
        v, e = load_wireframe(os.path.join(out_dir, name))
        if not np.isfinite(v).all() or (len(v) and np.abs(v[:, :2]).min()
                                        <= 1e5) or (len(e) and e.max()
                                                    >= len(v)):
            raise AssertionError(f"{name}: not a world-frame wireframe")
        verts_total += len(v)
    print(f"corpus test CLI: {len(objs)} .obj files, {verts_total} "
          f"vertices, all |x|, |y| > 1e5 (UTM frame); K1 launches {n}",
          flush=True)
    if len(objs) != 8 or n != 1 or not verts_total:
        raise AssertionError(f"test wrote {objs} with {n} K1 launches")
    return {"K1": k1, "K2": train_counts["K2"], "K3": train_counts["K3"],
            "K4": train_counts["K4"], "K5 fwd": 0, "K5 bwd": 0}


# ---------------------------------------------------------------------------
# Bench: the port's measuring instruments at the bench's default shapes
# ---------------------------------------------------------------------------
# Layouts: the recipe's decoder in every layout the JAX package builds
# ---------------------------------------------------------------------------

FUSED = ["model.decoder_fused_cross_kv=true"]
SCAN = ["model.decoder_scan=true"]
LAYOUTS = {"fused": FUSED, "scan": SCAN, "scan + fused": SCAN + FUSED,
           "remat": ["model.decoder_remat=true"]}
LAYOUT_STEPS = 5
# The scanned decoder against the unrolled one from the same weights:
# per layer the same products on slices of the stacked weights, so equal
# outputs are expected; the limit is one bf16 ulp of a unit-sphere
# vertex (2^-8) should the library pick another algorithm for a slice.
SCAN_ATOL = 2.0 ** -8


def _serve_layout(dev, card, work, label, flat, cfg, overrides, paths):
    """Serve `paths` with `flat` as a port checkpoint; returns (the
    predictor, its K1 launches, the batches served)."""
    from wireframe_tpu_torch.bridge import save_port_checkpoint
    from wireframe_tpu_torch.data.bucketing import choose_bucket
    from wireframe_tpu_torch.io.obj import load_wireframe
    from wireframe_tpu_torch.serve import WireframePredictor

    ckpt = os.path.join(work, "layout_" + label.replace(" + ", "_")
                        .replace(" ", "_"))
    save_port_checkpoint(ckpt, flat, cfg)
    predictor = WireframePredictor(ckpt, config=RECIPE, overrides=overrides,
                                   device=dev)
    sizes = [int(os.path.basename(p).split("_")[1].split(".")[0])
             for p in paths]
    per_bucket = {}
    for n in sizes:
        b = choose_bucket(n, predictor.buckets)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    batches = sum(-(-k // predictor.batch_size) for k in per_bucket.values())
    reset_launches()
    t0 = time.perf_counter()
    results = predictor.predict_files(paths, out_dir=ckpt + "_obj")
    secs = time.perf_counter() - t0
    k1 = launch_counts()["K1"]
    for r in results:
        lv, le = load_wireframe(r["obj_path"])
        if not np.isfinite(r["vertices"]).all() or (
                lv.shape != r["vertices"].shape
                or len(le) != r["num_edges"]):
            raise AssertionError(f"{label}: {r['obj_path']} does not load "
                                 "back")
    print(f"layout {label}: served {len(paths)} clouds over buckets "
          f"{sorted(per_bucket)} in {batches} batches, {secs:.2f} s (files "
          f"read and written); K1 launches {k1}; "
          f"{sum(r['num_vertices'] for r in results)} vertices, "
          f"{sum(r['num_edges'] for r in results)} edges, every .obj loads "
          f"back [{card}]", flush=True)
    if k1 != batches or sorted(per_bucket) != sorted(predictor.buckets):
        raise AssertionError(f"{label}: K1 launched {k1} times for "
                             f"{batches} batches over {per_bucket}")
    return predictor, k1, batches


def _forward_buckets(predictor, paths):
    """The predictor's model outputs on each bucket's batch of `paths`."""
    from wireframe_tpu_torch.data.bucketing import choose_bucket

    clouds = [predictor._preprocess(np.loadtxt(p))["pc"] for p in paths]
    outs = []
    for bucket in predictor.buckets:
        pcs = [pc for pc in clouds
               if choose_bucket(len(pc), predictor.buckets) == bucket]
        outs.append(predictor._forward(predictor.batch_array(
            pcs[:predictor.batch_size], bucket)))
    return outs


def _train_layout(torch, dev, cfg, batch, flat, plain=False):
    """train_model from `flat` on the one batch; returns (losses, launch
    counts, the final state)."""
    from wireframe_tpu_torch.bridge import params_from_flax
    from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
    from wireframe_tpu_torch.train.loop import train_model
    from wireframe_tpu_torch.train.state import create_train_state

    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    state = create_train_state(cfg, model.to(dev))
    writer = _Losses()
    reset_launches()
    with plain_kernels() if plain else contextlib.nullcontext():
        state = train_model(cfg, [batch], metric_writer=writer, state=state,
                            device=dev)
    torch.cuda.synchronize()
    return [r["total_loss"] for r in writer.rows], launch_counts(), state


def _loss_grads_saved(torch, model, cfg, dbatch, seed):
    """One train-mode forward, loss and backward with dropout draws from a
    generator seeded `seed`: (loss, gradients by name, bytes of the
    tensors autograd saved, each storage once, weights and batch
    excluded)."""
    from wireframe_tpu_torch.losses.wireframe_loss import wireframe_loss
    from wireframe_tpu_torch.train.step import loss_config

    gen = torch.Generator(device=dbatch["point_clouds"].device)
    gen.manual_seed(seed)
    kept = {t.untyped_storage().data_ptr() for t in [
        *model.parameters(), *dbatch.values()]}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in kept:
            saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        preds = model(dbatch["point_clouds"], dbatch["vertex_counts"],
                      train=True, generator=gen)
        loss = wireframe_loss(preds, {
            "vertices": dbatch["target_vertices"],
            "vertex_existence": dbatch["vertex_existence"],
            "edge_labels": dbatch["edge_labels"],
            "vertex_counts": dbatch["vertex_counts"]},
            loss_config(cfg))["total_loss"]
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {k: g for k, g in zip(names, grads) if g is not None}
    return loss.detach(), grads, sum(saved.values()), gen.get_state()


def layouts_phase(torch, dev, card, work):
    """The full-width recipe in the fused, scanned, scanned + fused and
    remat layouts, each from `init_flax_params` for its own tree: served
    over all four buckets (K1 once per batch), trained 5 steps (K2, K3, K4
    once per step; the first 3 losses against the plain versions); the
    scanned decoder from the unrolled weights restacked against the
    unrolled one; remat's gradients against no remat with dropout on;
    ms per step, device ops (tools/trace_ops) per layout beside the
    unrolled layout's.  Returns {kernel: launches on this path}."""
    from wireframe_tpu_torch.bridge import (
        init_flax_params,
        params_from_flax,
        stack_layers,
    )
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
    from wireframe_tpu_torch.tools import trace_ops
    from wireframe_tpu_torch.train.loop import device_batch
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.utils.synth import make_box_building_batch

    base = ["train.overfit_one_batch=true", "train.log_every=1",
            f"train.num_epochs={LAYOUT_STEPS}"]
    rng = np.random.default_rng(4)
    offset = np.array([534000.0, 6588000.0, 40.0])
    paths = []
    for i, n in enumerate((1300, 2048, 3000, 4096, 6000, 8192, 12000,
                           20000)):
        p = os.path.join(work, f"layoutcloud{i}_{n}.xyz")
        np.savetxt(p, synthetic_building(rng, n, offset), fmt="%.4f")
        paths.append(p)
    batch = make_box_building_batch(load_config(RECIPE, base), 8, seed=0)
    totals = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5 fwd", "K5 bwd")}
    step_ms, ops = {}, {}
    for label, extra in (("unrolled", []), *LAYOUTS.items()):
        cfg = load_config(RECIPE, base + extra)
        flat = init_flax_params(cfg.model, SERVE_SEED)
        if label != "unrolled":
            # The main path: serve, then train.
            _, k1, _ = _serve_layout(dev, card, work, label, flat, cfg,
                                     extra, paths)
            totals["K1"] += k1
            losses, counts, state = _train_layout(torch, dev, cfg, batch,
                                                  flat)
            print(f"layout {label}: {LAYOUT_STEPS} steps, losses "
                  f"{losses}; launches {counts}", flush=True)
            want = {"K1": 0, "K2": LAYOUT_STEPS, "K3": LAYOUT_STEPS,
                    "K4": LAYOUT_STEPS, "K5 fwd": 0, "K5 bwd": 0}
            if counts != want or not all(map(math.isfinite, losses)):
                raise AssertionError(f"{label}: launches {counts}, "
                                     f"expected {want}; losses {losses}")
            for k, v in counts.items():
                totals[k] += v
            plain_cfg = load_config(RECIPE, base[:2] + ["train.num_epochs=3"]
                                    + extra)
            plain, _, _ = _train_layout(torch, dev, plain_cfg, batch, flat,
                                        plain=True)
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
            print(f"layout {label}: first 3 losses, kernels {losses[:3]} vs "
                  f"plain versions {plain}: max rel diff {max(rel):.2e} "
                  f"(rtol {TRAIN_LOSS_RTOL})", flush=True)
            if max(rel) > TRAIN_LOSS_RTOL:
                raise AssertionError(f"{label}: losses differ from the "
                                     "plain run")
        else:
            model = PointCloudToWireframe(cfg.model)
            model.load_state_dict(params_from_flax(flat), strict=True)
            state = create_train_state(cfg, model.to(dev))
        dbatch = device_batch(batch, dev)
        step_ms[label] = time_and_check_step(
            torch, cfg, state, dbatch, dev, card, TRAIN_KERNELS,
            f"layout {label}")
        result = _tool(trace_ops.main, [
            "--batch", "8", "--steps", "2", "--top", "8",
            "--config", RECIPE, "--device", str(dev), *_sets(extra)])
        ops[label] = result["events"] / result["steps"]
    b, n = batch["point_clouds"].shape[:2]
    print(f"layouts at batch {b} x {n} [{card}]: ms per step "
          + ", ".join(f"{k} {v:.2f}" for k, v in step_ms.items())
          + "; device ops per step (tools/trace_ops) "
          + ", ".join(f"{k} {v:.0f}" for k, v in ops.items()), flush=True)

    # The scanned decoder from the unrolled weights, restacked: the
    # unrolled decoder's served outputs and first losses.
    for fused in ([], FUSED):
        u_cfg = load_config(RECIPE, base[:2] + ["train.num_epochs=3"]
                            + fused)
        s_cfg = load_config(RECIPE, base[:2] + ["train.num_epochs=3"]
                            + fused + SCAN)
        flat = init_flax_params(u_cfg.model, SERVE_SEED)
        stacked = stack_layers(flat, u_cfg.model.decoder_layers)
        tag = "scan + fused" if fused else "scan"
        served = []
        for lab, w, c, extra in (("unrolled", flat, u_cfg, fused),
                                 ("restacked", stacked, s_cfg,
                                  fused + SCAN)):
            predictor = _serve_layout(dev, card, work, f"{tag} vs {lab}",
                                      w, c, extra, paths)[0]
            served.append(_forward_buckets(predictor, paths))
        v_err = max(float(np.abs(a[k] - b[k]).max())
                    for a, b in zip(*served) for k in a)
        runs = [_train_layout(torch, dev, c, batch, w)[0]
                for c, w in ((u_cfg, flat), (s_cfg, stacked))]
        l_err = max(abs(a - b) / abs(b) for a, b in zip(*runs))
        print(f"{tag} from the unrolled weights restacked: served outputs "
              f"(vertices, existence and edge probabilities, every bucket) "
              f"max abs diff {v_err:.3e}, first losses {runs[1]} vs "
              f"unrolled {runs[0]} (max rel diff {l_err:.3e}); bit-equal "
              f"{v_err == 0.0 and runs[0] == runs[1]} (limits {SCAN_ATOL} "
              f"and {TRAIN_LOSS_RTOL})", flush=True)
        if v_err > SCAN_ATOL or l_err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"{tag} differs from the unrolled decoder")

    # Remat with the decoder's dropout on: the same loss and gradients as
    # without, fewer bytes saved for the backward.
    drop = ["model.decoder_dropout=0.1"]
    dbatch = device_batch(batch, dev)
    flat = init_flax_params(load_config(RECIPE, base).model, SERVE_SEED)
    out = {}
    for label, extra in (("no remat", []),
                         ("remat", ["model.decoder_remat=true"])):
        cfg = load_config(RECIPE, base + drop + extra)
        model = PointCloudToWireframe(cfg.model)
        model.load_state_dict(params_from_flax(flat), strict=True)
        out[label] = _loss_grads_saved(torch, model.to(dev).train(), cfg,
                                       dbatch, seed=5)
        del model
    (l0, g0, b0, s0), (l1, g1, b1, s1) = out["no remat"], out["remat"]
    g_err = max(float((g0[k] - g1[k]).abs().max()) for k in g0)
    same = (torch.equal(l0, l1) and torch.equal(s0, s1)
            and all(torch.equal(g0[k], g1[k]) for k in g0))
    print(f"remat with decoder dropout 0.1: loss {float(l1)} vs "
          f"{float(l0)}, gradients max abs diff {g_err:.3e}, bit-equal "
          f"(loss, gradients, generator state) {same}; autograd saved "
          f"{b1 / 1e6:.2f} MB with remat, {b0 / 1e6:.2f} MB without "
          f"({(b0 - b1) / 1e6:.2f} MB less) [{card}]", flush=True)
    if not same or not b1 < b0:
        raise AssertionError("remat changes the gradients or saves no "
                             "memory")
    return totals


# ---------------------------------------------------------------------------
# Checkpoints: the reference's .pth and a scanned, fused checkpoint resumed
# ---------------------------------------------------------------------------

CKPT_STEPS = 4
CKPT_EPOCH = 2


def _eval_vertices(evaluate_cli, argv):
    """Run the evaluate CLI; returns (the printed lines, the vertices of
    every forward batch it ran)."""
    import io

    from wireframe_tpu_torch.eval import evaluator

    made = evaluator.make_forward_fn
    seen = []

    def recording(*args, **kw):
        fn = made(*args, **kw)

        def forward(clouds):
            out = fn(clouds)
            seen.append(out["vertices"])
            return out
        return forward

    buf = io.StringIO()
    evaluator.make_forward_fn = recording
    try:
        with contextlib.redirect_stdout(buf):
            rc = evaluate_cli.main(argv)
    finally:
        evaluator.make_forward_fn = made
    if rc != 0:
        raise AssertionError(f"evaluate {argv} returned {rc}")
    print(buf.getvalue().rstrip(), flush=True)
    return buf.getvalue().splitlines(), seen


def checkpoints_phase(torch, dev, card, work):
    """A reference-layout `.pth` (reference widths, 64 slots) evaluated
    through `evaluate --torch-checkpoint` in f32 and through K1 in bf16;
    a scanned, fused recipe checkpoint with its Adam state resumed twice
    to the same losses.  Returns {kernel: launches on this path}."""
    from wireframe_tpu_torch import evaluate as evaluate_cli
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.train.checkpoint import (
        latest_step,
        restore_train_state,
    )
    from wireframe_tpu_torch.train.loop import init_model, train_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.utils.synth import (
        make_box_building_batch,
        reference_state_dict,
    )

    cfg = load_config(PARITY)
    sd = {k: torch.from_numpy(v).to(dev)
          for k, v in reference_state_dict(cfg, seed=0).items()}
    pth = os.path.join(work, "trained_model.pth")
    torch.save(sd, pth)
    root = os.path.join(work, "corpus")
    argv = ["--config", PARITY, "--data-root", root, "--torch-checkpoint",
            pth, "--device", str(dev)]
    counts, lines, verts = {}, {}, {}
    for label, extra in (("f32", []), ("bf16 K1", PARITY_SET)):
        reset_launches()
        t0 = time.perf_counter()
        lines[label], verts[label] = _eval_vertices(evaluate_cli,
                                                    argv + _sets(extra))
        torch.cuda.synchronize()
        counts[label] = launch_counts()
        print(f"checkpoints: evaluate --torch-checkpoint ({label}) "
              f"{time.perf_counter() - t0:.2f} s, {len(verts[label])} "
              f"forward batches; launches {counts[label]} [{card}]",
              flush=True)
        values = [float(ln.split()[-1]) for ln in lines[label]
                  if ln.split() and ln.split()[0] in (
                      "Wireframe", "Average", "Corners", "Edges")]
        if len(values) != 8 or not all(map(math.isfinite, values)):
            raise AssertionError(f"evaluate ({label}) metrics {values}")
    batches = len(verts["bf16 K1"])
    want = {"f32": 0, "bf16 K1": batches}
    if any(counts[k]["K1"] != n for k, n in want.items()) or any(
            v for c in counts.values() for k, v in c.items() if k != "K1"):
        raise AssertionError(f"evaluate launches {counts}")
    err = max(float(np.abs(a - b).max())
              for a, b in zip(verts["f32"], verts["bf16 K1"]))
    print(f"checkpoints: .pth model vertices, bf16 with K1 against f32 "
          f"plain: max abs diff {err:.3e} (atol "
          f"{MODEL_ATOL['vertices']})", flush=True)
    if len(verts["f32"]) != batches or err > MODEL_ATOL["vertices"]:
        raise AssertionError("the .pth model's bf16 K1 vertices differ")

    # A scanned, fused recipe checkpoint with Adam state, resumed twice.
    ckdir = os.path.join(work, "scan_fused_ckpt")
    sf = SCAN + FUSED + [
        "train.overfit_one_batch=true", "train.log_every=1",
        "train.lr_schedule=constant", f"train.num_epochs={CKPT_STEPS}",
        f"train.checkpoint_every={CKPT_EPOCH}",
        f"train.checkpoint_dir={ckdir}"]
    cfg = load_config(RECIPE, sf)
    batch = make_box_building_batch(cfg, 8, seed=0)
    writer = _Losses()
    reset_launches()
    train_model(cfg, [batch], metric_writer=writer, device=dev)
    losses = [r["total_loss"] for r in writer.rows]
    runs = []
    for _ in range(2):
        fresh = create_train_state(cfg, init_model(cfg, dev, seed=7))
        fresh, start = restore_train_state(fresh, ckdir)
        w = _Losses()
        train_model(cfg, [batch], metric_writer=w, state=fresh,
                    start_epoch=start, device=dev)
        runs.append([r["total_loss"] for r in w.rows])
    torch.cuda.synchronize()
    train_counts = launch_counts()
    n = CKPT_STEPS + 2 * (CKPT_STEPS - CKPT_EPOCH)
    print(f"checkpoints: scan + fused, {CKPT_STEPS} steps {losses}, "
          f"resumed twice from step {latest_step(ckdir)}: {runs}, "
          f"bit-identical {runs[0] == runs[1]}; launches {train_counts} "
          f"[{card}]", flush=True)
    if (latest_step(ckdir) != CKPT_EPOCH or runs[0] != runs[1]
            or len(runs[0]) != CKPT_STEPS - CKPT_EPOCH
            or any(train_counts[k] != n for k in ("K2", "K3", "K4"))):
        raise AssertionError("the scan + fused checkpoint does not resume "
                             "to the same losses")
    return {k: counts["bf16 K1"][k] + train_counts[k] for k in train_counts}


# ---------------------------------------------------------------------------

# The bench's defaults (B=128 x 2560, bf16, the recipe) with fewer
# iterations than its 30 / 20.
BENCH_ENV = {"BENCH_ITERS": "10", "BENCH_LAT_ITERS": "10"}
BENCH_BUCKETS = "2048,4096,8192,16384"
BENCH_SWEEP = "2048,4096,8192"
# trace_ops' groups against the profiler's own device total.
TRACE_SUM_RTOL = 1e-3


def _tool(main_fn, argv):
    """Run a tool's main(argv) in this process; echo its stdout and
    return its last line, the tool's JSON result."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    out = buf.getvalue().rstrip()
    print(out, flush=True)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__} {argv} returned {rc}")
    return json.loads(out.splitlines()[-1])


def _bench(torch, dev, card, env, want):
    """One bench run with counts set to 0 just before it and read just
    after; every launch count must equal want(result)."""
    from wireframe_tpu_torch import bench

    reset_launches()
    t0 = time.perf_counter()
    result = bench.run(env, device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(json.dumps(result), flush=True)
    expected = want(result)
    print(f"bench {env}: {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}, expected {expected} [{card}]", flush=True)
    if counts != expected:
        raise AssertionError(f"bench launches {counts} != {expected}")
    return result, counts


def bench_phase(torch, dev, card, work):
    """The bench (`python -m wireframe_tpu_torch.bench`) in this process:
    the recipe forward with the parity pass, buckets and sweep, between
    two readings of the recipe's throughput alone for the spread; one
    profiled window; train mode for the recipe and
    the parity model; then the latency grid, the step profiler, the op
    trace and the cold-start report.  Returns {kernel: launches}."""
    from wireframe_tpu_torch import bench
    from wireframe_tpu_torch.tools import (
        bench_latency,
        profile_train_step,
        trace_ops,
    )

    none = {k: 0 for k in _counters()}

    def forward_launches(r):
        return {**none, "K1": r["forward_calls"]}

    # The spread: the recipe's throughput alone at the bench's 30
    # iterations, before and after the full forward run, each with the
    # card's clocks and power over its window; the three readings tell a
    # change that follows position from one that follows warm-up.
    spread_env = {**BENCH_ENV, "BENCH_ITERS": "30",
                  "BENCH_PARITY_SECONDARY": "0"}
    before, counts = _bench(torch, dev, card, spread_env, forward_launches)
    launches = dict(counts)

    # The recipe forward at B=128 x 2560, with the parity pass, the point
    # buckets and the sweep: K1 once per forward call.
    fwd, counts = _bench(torch, dev, card, {
        **BENCH_ENV, "BENCH_BUCKETS": BENCH_BUCKETS,
        "BENCH_SWEEP": BENCH_SWEEP}, forward_launches)
    launches["K1"] += counts["K1"]
    mfus = {"recipe": fwd["mfu"], "parity": fwd["parity_arch"]["mfu"],
            **{f"sweep {k}": v.get("mfu") for k, v in fwd["sweep"].items()}}
    lat = fwd["latency_ms"]
    print(f"bench recipe B={fwd['batch']} x {fwd['points']}: "
          f"{fwd['value']:.2f} clouds/s, mean_batch_ms "
          f"{fwd['mean_batch_ms']:.3f}, latency p50 {lat['p50']:.3f} p90 "
          f"{lat['p90']:.3f} p99 {lat['p99']:.3f} ms ({lat['iters']} trips); "
          f"parity {fwd['parity_arch']['value']:.2f} clouds/s "
          f"({fwd['parity_arch']['mean_batch_ms']:.3f} ms); mfu {mfus} "
          f"[{card}]", flush=True)
    for bucket, row in fwd["buckets"].items():
        print(f"bench bucket {bucket} (batch {row['batch']}): p50 "
              f"{row['p50_ms']:.3f} ms, p99 {row['p99_ms']:.3f} ms, "
              f"{row['round_trip_clouds_per_sec']:.1f} round-trip clouds/s "
              f"[{card}]", flush=True)
    for n_pts, row in fwd["sweep"].items():
        print(f"bench sweep {n_pts} points x {row.get('batch')}: {row} "
              f"[{card}]", flush=True)
    if any("error" in row for row in fwd["sweep"].values()):
        raise AssertionError(f"a sweep point failed: {fwd['sweep']}")
    if not all(m is not None and 0 < m < 1 for m in mfus.values()):
        raise AssertionError(f"mfu outside (0, 1): {mfus}")

    after, counts = _bench(torch, dev, card, spread_env, forward_launches)
    launches["K1"] += counts["K1"]
    for label, r, n in (("before", before, spread_env["BENCH_ITERS"]),
                        ("full run", fwd, BENCH_ENV["BENCH_ITERS"]),
                        ("after", after, spread_env["BENCH_ITERS"])):
        c = r.get("card_samples", {})
        print(f"bench recipe throughput {label} ({r['mean_batch_ms']:.3f} "
              f"ms a batch over {n} iterations): {r['value']:.2f} "
              f"clouds/s; SM MHz "
              f"{c.get('clocks.sm')}, W {c.get('power.draw')}, C "
              f"{c.get('temperature.gpu')} over {c.get('samples')} samples "
              f"[min, mean, max] [{card}]", flush=True)
    print(f"bench recipe throughput ratios: after / before "
          f"{after['value'] / before['value']:.4f}, full run / before "
          f"{fwd['value'] / before['value']:.4f} [{card}]", flush=True)

    # One profiled chained window: the device's busy share.
    trace_dir = os.path.join(work, "bench_trace")
    prof, counts = _bench(torch, dev, card, {
        **BENCH_ENV, "BENCH_PARITY_SECONDARY": "0", "BENCH_LAT_ITERS": "2",
        "BENCH_PROFILE": trace_dir}, forward_launches)
    launches["K1"] += counts["K1"]
    totals, events = trace_ops.aggregate_device_events(trace_dir)
    iters = int(BENCH_ENV["BENCH_ITERS"])
    busy = sum(totals.values()) / 1e3 / iters
    k1 = sum(us for name, us in totals.items() if trace_ops.classify(name)
             in ("K1 (fused encoder)", "K2/K3/K5 (encoder chain)")) / 1e3
    print(f"bench profiled window ({iters} chained batches, {events} device "
          f"events): device busy {busy:.3f} ms per batch of which K1 "
          f"{k1 / iters:.3f} ms; {busy / prof['mean_batch_ms'] * 100:.1f}% "
          f"of the profiled mean_batch_ms {prof['mean_batch_ms']:.3f}, "
          f"{busy / fwd['mean_batch_ms'] * 100:.1f}% of the unprofiled "
          f"{fwd['mean_batch_ms']:.3f} [{card}]", flush=True)
    if not busy > 0:
        raise AssertionError("the profiled window shows no device time")

    # f32 with the fused encoder raises on the card: no fallback.
    try:
        bench.run({"BENCH_DTYPE": "float32", "BENCH_BATCH": "2",
                   "BENCH_POINTS": "2048", "BENCH_ITERS": "1",
                   "BENCH_PARITY_SECONDARY": "0"}, device=dev)
    except ValueError as exc:
        print(f"bench BENCH_DTYPE=float32 raises: {exc}", flush=True)
    else:
        raise AssertionError("the bench ran float32 with the fused encoder")

    # Train mode: the recipe (K2, K3, K4) and the parity model (K5, K4),
    # each once per step.
    for label, extra, kernels in (
            ("recipe", {}, ("K2", "K3", "K4")),
            ("parity", {"BENCH_CONFIG": "parity"},
             ("K5 fwd", "K5 bwd", "K4"))):
        tr, counts = _bench(
            torch, dev, card, {**BENCH_ENV, "BENCH_TRAIN": "1", **extra},
            lambda r: {**none, **{k: r["steps"] for k in kernels}})
        for k in kernels:
            launches[k] += counts[k]
        print(f"bench train {label} B={tr['batch']} x {tr['points']}: "
              f"{tr['value']:.2f} training clouds/s, {tr['mean_batch_ms']:.3f}"
              f" ms/step, forward-FLOP mfu {tr['mfu']:.4f} [{card}]",
              flush=True)

    # The tools.
    t0 = time.perf_counter()
    grid = _tool(bench_latency.main, [
        "--config", RECIPE, "--batches", "1,8", "--buckets", "2048,16384",
        "--iters", "20", "--out", os.path.join(work, "latency.md"),
        "--device", str(dev)])
    print(f"bench_latency grid in {time.perf_counter() - t0:.1f} s: "
          + "; ".join(f"{k} p50 {g['p50_ms']:.3f} p99 {g['p99_ms']:.3f} ms"
                      for k, g in grid["grid"].items()) + f" [{card}]",
          flush=True)
    t0 = time.perf_counter()
    _tool(profile_train_step.main, ["--device", str(dev)])
    print(f"profile_train_step in {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    t0 = time.perf_counter()
    ops = _tool(trace_ops.main, ["--batch", "64", "--steps", "6",
                                 "--top", "25", "--device", str(dev)])
    groups = ops["groups_ms"]
    gap = abs(sum(groups.values()) - ops["profiler_device_ms"])
    print(f"trace_ops in {time.perf_counter() - t0:.1f} s: groups sum "
          f"{sum(groups.values()):.4f} ms/step against the profiler's "
          f"{ops['profiler_device_ms']:.4f} (gap {gap:.2e}, limit "
          f"{TRACE_SUM_RTOL} relative) [{card}]", flush=True)
    if gap > TRACE_SUM_RTOL * ops["profiler_device_ms"] or not (
            groups.get("K2/K3/K5 (encoder chain)", 0) > 0
            and groups.get("K4 (lockstep JV)", 0) > 0):
        raise AssertionError(f"trace_ops groups {groups}")

    # The cold start, in a process of its own, building into its default
    # fresh directory under build/cold/, which it removes when it ends.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wireframe_tpu_torch.tools.compile_report"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=400)
    print(proc.stderr.rstrip(), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"compile_report failed: {proc.stdout[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"compile_report in {time.perf_counter() - t0:.1f} s (process "
          f"included): {json.dumps(report)} [{card}]", flush=True)
    if os.path.exists(report["build_dir"]):
        raise AssertionError(f"compile_report left {report['build_dir']}")
    return launches


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
        from wireframe_tpu_torch.utils.platform import card_line

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
            torch, dev, card, ((3, 2048), (3, 16384), (64, 2560),
                               (128, 2560)))

        phase = "K4 kernel and times"
        k4 = k4_phase(torch, dev, card)

        phase = "chain GEMMs against torch.matmul"
        gemm_phase(torch, dev, card)

        phase = "K2 / K3 kernels and times"
        chain = chain_phase(torch, dev, card)

        phase = "K5 kernels and times"
        k5 = k5_phase(torch, dev, card)
        errs = {"K2": chain["K2"]["max_abs_err"],
                "K3": chain["K3"]["max_abs_err"],
                "K5 forward": k5["forward"]["max_abs_err"],
                "K5 backward": k5["backward"]["max_abs_err"]}
        print(f"chain max_abs_err {errs}; identical to the recorded ones: "
              f"{errs == CHAIN_MAX_ABS}", flush=True)
        if errs != CHAIN_MAX_ABS:
            raise AssertionError(f"a chain kernel's error changed: recorded "
                                 f"{CHAIN_MAX_ABS}")

        phase = "training"
        train_launches, _ = training_phase(torch, dev, card, work)

        phase = "parity training"
        parity_launches, _ = parity_phase(torch, dev, card, work)

        phase = "serving"
        launches, batches = serving_phase(torch, dev, card, work)
        if launches != batches:
            raise AssertionError(f"K1 launched {launches} times for "
                                 f"{batches} batches")

        phase = "corpus"
        corpus = corpus_phase(torch, dev, card, work)

        phase = "layouts"
        t0 = time.perf_counter()
        layouts = layouts_phase(torch, dev, card, work)
        print(f"layouts phase: {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)

        phase = "checkpoints"
        t0 = time.perf_counter()
        ckpts = checkpoints_phase(torch, dev, card, work)
        print(f"checkpoints phase: {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)

        phase = "bench"
        t0 = time.perf_counter()
        bench = bench_phase(torch, dev, card, work)
        print(f"bench phase: {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)

        b, n = 3, 16384
        ms, plain_ms, bound, bound_by = timing[(b, n)]
        src = "wireframe_tpu_torch/csrc/"
        kernels = [{
            "name": "fused_point_encoder (K1)", "route": "cuda",
            "source": f"{src}fused_encoder.cu + {src}hopper_gemm.cuh",
            "replaces": "wireframe_tpu/ops/pallas_encoder.py:71",
            "launches": launches, "corpus_launches": corpus["K1"],
            "layouts_launches": layouts["K1"],
            "checkpoints_launches": ckpts["K1"],
            "bench_launches": bench["K1"],
            "max_abs_err": k1_abs,
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
                            "launches": train_launches[key],
                            "corpus_launches": corpus[key],
                            "layouts_launches": layouts[key],
                            "checkpoints_launches": ckpts[key],
                            "bench_launches": bench[key], **fields,
                            "library_ms": None})
        for key, count, name, replaces in (
                ("forward", "K5 fwd", "chain forward, remat (K5)",
                 "wireframe_tpu/ops/pallas_chain_grad.py:159"),
                ("backward", "K5 bwd", "chain backward, remat (K5)",
                 "wireframe_tpu/ops/pallas_chain_grad.py:400")):
            kernels.append({"name": name, "route": "cuda",
                            "source": src + "chain_grad.cu",
                            "replaces": replaces,
                            "launches": parity_launches[count],
                            "corpus_launches": corpus[count],
                            "layouts_launches": layouts[count],
                            "checkpoints_launches": ckpts[count],
                            "bench_launches": bench[count],
                            **k5[key], "library_ms": None})
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
