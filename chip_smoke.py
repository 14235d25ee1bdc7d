"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits nonzero and prints no final `ok` line):
  1. device   — require CUDA; print the card's name and power limit;
  2. build    — compile K1 (fused_encoder.cu), K2 + K3 + K5 (chain_grad.cu),
                K4 (lockstep_lsa.cu), the split stages' row kernels
                (layernorm_rows.cu), the pair MLP (pair_mlp.cu) and the
                submanifold conv (subm_conv.cu) from
                wireframe_tpu_torch/csrc/, one
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
  7b. pair MLP — the edge head's pair MLP kernel (pair_mlp.cu) against
                its plain version at (512, 40), (3, 40), (7, 64) and a
                ragged last tile, bounded by twice the plain version's own
                gap to the same math in f32; its time, the plain version's
                and its bound; one launch per served recipe forward, one
                pair_mlp_kernel a forward on the device (edge
                probabilities held to the eager path's), none at
                edge_hidden_dim 1024 (edge probabilities returned), none
                in 20 recipe and 20 parity train steps;
  8. f32      — the encoder-chain kernels computing in float32, within
                60 s: (a) the reference-parity model as shipped
                (configs/default.yaml + model.use_pallas_encoder=true, f32)
                trained 20 steps at 3 x 2560 (K5 f32 forward and backward
                and K4 once per step, the loss falling at lr 1e-4, the
                first 3 losses against the plain versions with the targets
                next to predicted slots) and served over the four buckets
                (K1 f32 once per batch, .obj files load back, one batch
                against the plain f32 encoder); (b) the recipe at
                model.compute_dtype=float32 with the stash chain, 5 steps
                at 8 x 2560 (K2 f32, K3 f32, K4 once per step; first 3
                losses against the plain versions); (c) K1 f32 at (3,
                2560), (3, 16384), (128, 2560) and ragged shapes, K2 / K3
                f32 at (8, 2560), K5 f32 at (3, 2560) and (128, 2560) and
                ragged shapes in each flavour, against the plain f32
                versions (TF32 off), every f32 plan on the 3xTF32 loop,
                K1 array_equal to K5's forward, two launches array_equal,
                at every shape the time, % of the 3xTF32 bound and largest
                error beside the FFMA loop's, K1's peak memory, and per
                chain shape the widest stage's bare product, the STORE
                GEMM beside torch.matmul in f32;
  9. limits   — every shape the JAX kernels take, within 60 s: (a) the
                recipe at data.max_vertices=256 (K4 on (8, 256, 256), its
                costs in device memory) served one batch per bucket and
                trained 5 steps at 8 x 2560 (K2, K3, K4 once per step,
                the first 3 losses against the plain versions); (b) the
                recipe with encoder widths (512, 1024, 4096, 1024): the
                4096 stage runs split (its GEMM writes the f32 product,
                the LayerNorm row kernels of layernorm_rows.cu do the
                rest), served through K1 over the four buckets and trained
                5 steps through K2 / K3; (c) the parity model as shipped
                (f32) with those widths, 3 steps at 3 x 2560 through K5
                f32 and K4; then K4 at (8, 256, 256), (4, 300, 512), (2,
                64, 1024) and (1, 32, 16384) against its plain version
                (random costs, ties, -0.0, a NaN row, counts 0 and R) with
                ns per scan step; K1, K2, K3, K5 in bf16 and f32 at (8,
                2560) with the 4096 stage and at (2, 328) with widths
                (2304, 8192) and out 2304 against their plain versions,
                K1 and K5's forward array_equal to K2's, two launches
                equal; the split stage and each row kernel timed, each
                row kernel shown to be one kernel launch a call, beside
                the LayerNorm-alone yardsticks (layer_norm and
                native_layer_norm_backward in f32: not the same
                function); each row kernel against its plain version at
                ROWS_RAGGED (ragged tails, column chunks);
 10. training — the full-width recipe train step (train_model, overfit
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
 11. parity   — the reference-parity model (configs/default.yaml with the
                fused bf16 encoder: MLP vertex head, remat chain, matcher
                "device") trained 20 steps at batch 3 x 2560: K5 forward,
                K5 backward and K4 once per step, K2 / K3 never; the first
                3 losses against the plain versions; a falling loss; the
                checkpoint of epoch 10 resumed twice to the same losses;
                the memory the forward leaves for the backward, remat
                against stash; ms per step, profile, no host sync; the
                trained checkpoint served over all four buckets with K1;
 12. ptv3     — Point Transformer V3 as the recipe's backbone at its
                published widths (`model.encoder: ptv3`): the forward at
                (8, 16384) against the benchmark's plain reference
                (`port_bench/reference/ptv3.py`) within the cell's limits,
                with CUDA's sync debug mode at "error" (no host
                synchronisation), the five spans inside the encoder's,
                ms, peak memory and the device counters at (8, 16384) and
                (128, 16384) with one pair MLP launch a forward (and one
                pair_mlp_kernel on the device), a call over
                a stage's capacity raising on readback and the next one
                served, one train step at (2, 4096); the submanifold conv
                kernel (subm_conv.cu) at the 23 convolutions of a (128,
                16384) call, on their own maps, against its plain version
                (within twice the plain version's gap to f32; rows with no
                neighbour exactly the bias), its ms beside its bound and
                the plain version's, 23 launches a ptv3 forward (23
                subm_conv_kernel on the device) and none in the training
                and parity phases, the share of its steps skipped; the
                neighbour map kernel (neighbour_map.cu) at the 6 maps of
                an (8, 16384) and a (128, 16384) call, torch.equal to its
                plain version with equal pairs, its ms beside its bound
                and the plain version's, the hit share, 6 launches a ptv3
                forward (6 nbr_table_kernel and 6 nbr_query_kernel on the
                device); the (128, 16384) forward under sync debug mode;
 12b. ptv2    — Point Transformer V2 (`PT-v2m2`) as the recipe's
                backbone at its published widths (`model.encoder: ptv2`):
                the kNN kernel (knn.cu) at every level of an (8, 16384)
                and a (128, 16384) call torch.equal to `knn_plain`, its ms
                beside its bound and the plain version's; the GVA kernel
                (gva.cu) at every GVA of the same calls within 0.01 of
                `gva_plain` in bf16, its skipped rows those without a
                neighbour, its ms beside its bound and the plain
                version's; 5 knn and 17 gva launches a forward (5
                knn_kernel, 17 gva_kernel and one pair_mlp_kernel on the
                device); the forward at (8, 16384) against the benchmark's
                plain reference (`port_bench/reference/ptv2.py`) within
                the cell's limits; both forwards under CUDA's sync debug
                mode at "error"; the five spans inside the encoder's; ms,
                peak memory and the device counters; a call over a level's
                capacity raising on readback and the next one served; the
                train step refused at build;
 13. serving  — the full-width recipe WireframePredictor (random weights
                from a numpy seed, carried over through the flax bridge)
                serves synthetic .xyz clouds across all four point
                buckets; the K1 launch count must equal the batches
                served; .obj files must load back; one batch is compared
                between the kernel and the plain encoder chain; serving
                time per bucket, and a torch.profiler breakdown of one
                batch per bucket (device busy share, K1 against the rest;
                each of K1's kernels must be in it, the profile opening
                with spin kernels that take the records a long process's
                profiler loses);
 14. corpus   — the recipe at full width from a generated Building3D
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
 15. layouts  — the full-width recipe's decoder in the layouts the JAX
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
 16. checkpoints — a state_dict in the reference's own layout (its
                widths, 64 slots) `torch.save`d and evaluated through
                `evaluate --torch-checkpoint` on the corpus's test split in
                f32 (the plain encoder), in bf16 through K1 and in f32
                through K1 f32 (once per forward batch): finite metrics,
                the bf16 run's vertices within MODEL_ATOL of the plain
                f32 run's, the f32 K1 run's within the f32 forward atol;
                a scanned + fused recipe checkpoint with its Adam state
                resumed twice to the same losses;
 17. parser   — every .xyz of the corpus phase's corpus read by the C++
                parser (`io/native`, built with g++ into build/native/)
                and by np.loadtxt: array_equal float64 arrays, ms per
                file of each; the library loaded and no cloud of the
                whole run read by numpy; on one served batch of the
                corpus's model, the adjacency ops' round trip equal to
                (p > t) on the card;
 18. study    — `tools.seed_study` on that corpus (seeds 0 and 1, 2
                epochs, EMA and decoded; every subprocess on CUDA): 6
                records, each naming the card; then `tools.study_report`
                on them;
 19. parallel — more than one device on the one card, within 90 s:
                (a) `evaluate --sharded 4` of the corpus phase's EMA
                checkpoint, shard by shard and pipelined: counters
                array_equal to the plain runs', K1 once per forward
                batch, clouds/s of each; (b) the recipe's data-parallel
                step (batch 8 x 2560, constant LR) through a real NCCL
                group of one rank: params array_equal to the plain step's
                after each of 3 steps, K2 / K3 / K4 once per step, the
                collective audit; (c) two ranks sharing the card over
                gloo, the recipe at full width on a global batch of
                16 x 2560 (device augmentation on, dropout off, targets
                next to predicted slots) against one process on the 16
                rows: step 1's losses within the JAX mesh test's bounds,
                step 1's first moment (the gradient) within a relative L2
                bound, the params after step k within 2.1 k lr, K2 / K3 /
                K4 once per step on each rank; (d) `sharded_point_pools`
                at mp = 2, (3, 16384), K1 once per rank, against the
                unsharded K1 call; (e) point-parallel training, the same
                two ranks at dp = 1 x mp = 2: the recipe at full width on
                8 x 2560 (each rank 8 x 1280 through K2 / K3) and the
                parity model on 3 x 2560 (K5), 3 steps each, against one
                process on the same batch: the gathered KV tokens
                array_equal to the one-process K2's, step 1's losses and
                first moment and every step's params within the bounds of
                (c), each kernel once per step on each rank.  A rank's
                non-zero exit fails the phase.  NCCL across two cards
                needs a machine with two;
 20. bench    — `wireframe_tpu_torch.bench` and its four tools at the
                bench's defaults (B=128 x 2560), and the recipe forward
                with BENCH_DTYPE=float32 through K1 f32.
Launches come from the port's registry (`ops._launch`); the checks of
kernels per call count device kernels by name in a profile.
Then a `kernels` JSON line (launches on the main paths, on the corpus,
layouts, checkpoints, parallel, bench and limits paths; the f32 kernels'
and the split stages' row kernels under their own entries; K4's per
variant) and, last, the `ok` JSON line.

Imports torch, numpy and the port only (and, in the ptv3 phase, the
benchmark's plain reference and its batch maker): no JAX, nothing of
wireframe_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
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
from unittest import mock

import numpy as np

from wireframe_tpu_torch.ops._launch import launch_counts, reset_launches

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (data sheet)
H100_BYTES_PER_S = 3.35e12    # HBM3
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores (data sheet)
# The f32 kernels' bound: f32-accurate products on the tensor cores, as
# three TF32 passes (hi*hi + hi*lo + lo*hi) at the dense TF32 peak.
H100_3XTF32_FLOPS = 494.7e12 / 3
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
                          hidden=(512, 1024, 2048, 1024), out=512,
                          weight_dtype=None):
    """Full-width encoder params with NONZERO biases and LayerNorm affine
    terms, so padding rows carry real features into the unmasked pools;
    weights in bf16 (default) or weight_dtype."""
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
    # The kernel reads weights in its compute dtype: hand both versions
    # the same ones.
    wdt = weight_dtype or torch.bfloat16
    stages = [(w.to(wdt), b, g, be) for w, b, g, be in stages]
    return stages, fw.to(wdt), fb


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


def _bound(flops, nbytes, f32):
    """(ms, "operations" or "bytes"): the larger of the operations at the
    peak for the operand type (bf16, or f32 as 3xTF32) and the bytes at
    the memory rate."""
    t_ops = flops / (H100_3XTF32_FLOPS if f32 else H100_BF16_FLOPS) * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k1_bound_ms(b, n, d, hidden, out, kv_pool, f32=False):
    """Least time for K1's work: operations at the peak for its operands
    against the bytes it must move (cloud in, weights in the compute
    dtype, pools and kv out)."""
    dims = [d, *hidden, out]
    macs = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    flops = 2.0 * b * n * macs
    weight_bytes = (4 if f32 else 2) * macs + 4 * 3 * sum(hidden) + 4 * out
    io_bytes = 4 * b * n * d + 4 * b * 4 * out + (
        4 * b * (n // kv_pool) * out if kv_pool else 0)
    return _bound(flops, weight_bytes + io_bytes, f32)


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
    fn()
    rows = device_profile(torch, fn)
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
    reset_launches()
    results = predictor.predict_files(paths, out_dir=out_dir)
    launches = launch_counts(MAIN_KEYS)["K1"]
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
# Late in a long process the profiler loses the first device records of
# each profile: none in a fresh process, 8 or more after the training
# phases, all 256 pads and more in the limits phase (PERF.md §7).  A
# profile (`device_profile`) opens with a warm-up step and this many
# one-cycle spin kernels, which its rows leave out.
PROFILE_PAD = 256
PAD_KERNEL = "spin_kernel"


def device_profile(torch, fn):
    """The device rows (`device_rows`) of one run of fn in a torch.profiler
    trace: a warm-up step of PROFILE_PAD spin kernels, then an active step
    of as many pads (left out; one must survive) and fn."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from wireframe_tpu_torch.utils.profiling import device_rows

    def pads():
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        pads()
        torch.cuda.synchronize()
        prof.step()
        pads()
        fn()
        torch.cuda.synchronize()
        prof.step()
    rows = device_rows(prof)
    kept = sum(r[1] for r in rows if PAD_KERNEL in r[2])
    if kept < PROFILE_PAD:
        print(f"device_profile: {PROFILE_PAD - kept} of the {PROFILE_PAD} "
              f"pads lost", flush=True)
    if not kept:
        raise AssertionError(f"the profile lost all {PROFILE_PAD} pads")
    return [r for r in rows if PAD_KERNEL not in r[2]]


def device_launches(torch, fn, names, tries=3):
    """The device kernels that one run of fn launches, by `__global__`
    name: {name: kernels whose name holds it}, the most over `tries`
    profiles (a profiler may drop records, never adds one)."""
    seen = [device_profile(torch, fn) for _ in range(tries)]
    counts = [{n: sum(r[1] for r in rows if n in r[2]) for n in names}
              for rows in seen]
    if any(c != counts[0] for c in counts):
        print(f"device_launches: the {tries} profiles read {counts}",
              flush=True)
    return {n: max(c[n] for c in counts) for n in names}


def profile_batch(torch, predictor, chunk, bucket, card):
    """Where one served batch's time goes: device time by kernel from
    torch.profiler, against the host wall clock of the same predict().
    Each of K1's kernels has to be in the profile."""
    wall = []

    def predict():
        t0 = time.perf_counter()
        predictor.predict(chunk)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    rows = device_profile(torch, predict)
    wall_ms = wall[0]
    device_ms = sum(r[0] for r in rows)
    k1_ms = sum(r[0] for r in rows if any(k in r[2] for k in K1_KERNELS))
    print(f"profile bucket {bucket}: wall {wall_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms ({device_ms / wall_ms * 100:.1f}%), K1 "
          f"{k1_ms:.2f} ms, rest of the model {device_ms - k1_ms:.2f} ms, "
          f"{sum(r[1] for r in rows)} device ops [{card}]", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}", flush=True)
    missing = [k for k in K1_KERNELS if not any(k in r[2] for r in rows)]
    if missing:
        raise AssertionError(f"the profile of bucket {bucket} lacks K1's "
                             f"{missing} among {[r[2] for r in rows]}")


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


def chain_bound_ms(b, n, d, hidden, out, kv_pool, backward, f32=False):
    """Least time for K2's (forward) or K3's (backward) work: tensor-core
    operations for its operands against the bytes each must move."""
    dims = [d, *hidden, out]
    macs = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    m = b * n
    esize = 4 if f32 else 2
    stash = esize * m * sum(hidden)
    kv = 3 * 4 * m // kv_pool * out if kv_pool else 0
    weights = esize * macs + 4 * (3 * sum(hidden) + out)
    if backward:
        flops = 4.0 * m * macs
        nbytes = 4 * m * d + stash + kv + weights + 4 * (
            macs + 3 * sum(hidden) + out) + 4 * m * d
    else:
        flops = 2.0 * m * macs
        nbytes = 4 * m * d + weights + stash + kv
    return _bound(flops, nbytes, f32)


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
    fn()
    rows = device_profile(torch, fn)
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
    from wireframe_tpu_torch.ops._launch import check, row_buffer
    from wireframe_tpu_torch.ops.hopper_gemm import BM, split_k

    lib = cg._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    bf = torch.bfloat16
    m = b * n

    def rows(r, c, dt=bf):
        t = row_buffer(r, c, dt, dev)
        t.normal_(generator=gen)
        return t

    def vec(c):
        return torch.randn(c, device=dev, generator=gen)

    dims = [d, *hidden, out]
    result = {"gemm_ms": 0.0, "matmul_ms": 0.0}
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        h, w, dz = rows(m, i), rows(i, o), rows(m, o)
        bias = vec(o)
        c_fwd = torch.empty(m, o, device=dev)
        c_dh = torch.empty(m, i, device=dev)
        slices = split_k(m, i, o)

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
            part = torch.empty(-(-m // BM), 3 * i, device=dev)
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
            # Counted, not from `within`: a float32 mean of N ones is
            # N * (1 / N) on the card, which reads 1 - 2^-24 for some N.
            if not bool((diff <= row_ulp).all()):
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
# K5's backward recomputes by row chunks (`chain_grad.remat_plan`).  Its
# peak device memory for one call, beyond what was allocated before it,
# is held to the plan's `peak_bytes` (the largest chunk's recomputed z
# and h with its dz, partials and dW slices, beside the seed, x, dx and
# the gradients, each as the caching allocator may count it), and the
# plan's figure to these limits: the plan's own at the default
# REMAT_CHUNK_BYTES, rounded up, per (dtype, B, N).
K5_BWD_PEAK = {("bf16", 3, 2560): 0.31e9, ("bf16", 128, 2560): 1.49e9,
               ("f32", 3, 2560): 0.42e9, ("f32", 128, 2560): 1.85e9}
# The same call in one chunk (the whole batch recomputed at once, as
# before the chunks), and a ragged shape forced through several chunks
# of one row tile (the last one shorter).
ONE_CHUNK = {"chunk_bytes": 1 << 62}
FORCED_CHUNKS = {"chunk_bytes": 1, "min_rows": 128}


def k5_bwd_peak(torch, label, key, plan, call, card):
    """The peak device memory of one K5 backward call beyond what was
    allocated before it, against the plan's peak_bytes and, at the shapes
    of K5_BWD_PEAK, the plan's figure against its limit.  Returns the
    figures for the kernels line."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    limit = K5_BWD_PEAK.get(key)
    ok = peak <= plan["peak_bytes"] and (
        limit is None or plan["peak_bytes"] <= limit)
    chunk = plan["chunk_peak"] / 1e9
    held = "none" if limit is None else f"{limit / 1e9} GB"
    print(f"{label}: K5 backward peak device memory {peak / 1e9:.4f} GB "
          f"beyond the {base / 1e9:.4f} GB allocated before it; plan "
          f"{plan['peak_bytes'] / 1e9:.4f} GB ({len(plan['chunks'])} "
          f"chunk(s) of {plan['chunk_rows']} rows, {chunk:.4f} GB a chunk; "
          f"limit {held}); the whole batch's f32 z and h at once: "
          f"{plan['whole_batch_bytes'] / 1e9:.4f} GB "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"{label}: K5 backward holds {peak} bytes, "
                             f"plan {plan['peak_bytes']}, limit {limit}")
    return {"peak_bytes": peak, "plan_peak_bytes": plan["peak_bytes"],
            "chunks": len(plan["chunks"]), "chunk_rows": plan["chunk_rows"],
            "whole_batch_bytes": plan["whole_batch_bytes"]}


def k5_close(label):
    """A check of two bf16 K5 backward results at K5_MAX_REL /
    K5_MEAN_REL."""
    def close(got, want):
        e = grad_errors(got, want)
        print(f"{label}: worst max rel err {e[0]:.2e} ({e[1]}), worst mean "
              f"rel err {e[2]:.2e} ({e[3]}) (limits {K5_MAX_REL}, "
              f"{K5_MEAN_REL})", flush=True)
        if e[0] > K5_MAX_REL or e[2] > K5_MEAN_REL:
            raise AssertionError(f"{label} disagrees")
    return close


def k5_chunks_equal(torch, label, gk, one, close):
    """K5's backward over several chunks against the same call in one
    chunk: dx, d final_b and every stage's d b, d gamma, d beta
    array_equal (the same rows, the same row tiles summed in the same
    order); every dW, whose K-slices differ, through `close` (the phase's
    gradient check).  Returns what was held equal."""
    flat = lambda r: [("dx", r[0])] + [  # noqa: E731
        (f"{t}{i}", v) for i, st in enumerate(r[1])
        for t, v in zip(("dW", "db", "dgamma", "dbeta"), st)] + [
        ("dW_proj", r[2]), ("db_proj", r[3])]
    equal = [name for name, _ in flat(gk) if not name.startswith("dW")]
    differ = [name for (name, a), (_, w) in zip(flat(gk), flat(one))
              if name in equal and not torch.equal(a, w)]
    print(f"{label}: {equal} array_equal to the one-chunk call: "
          f"{not differ}", flush=True)
    if differ:
        raise AssertionError(f"{label}: {differ} differ from one chunk")
    close(gk, one)
    return equal


def k5_bound_ms(b, n, d, hidden, out, kv_pool, emit, backward, f32=False):
    """Least time for K5's forward or backward: tensor-core operations for
    its operands (forward 2, backward 6 FLOP per multiply-add: recompute,
    dW, dh) against the bytes each must move (no stash)."""
    dims = [d, *hidden, out]
    macs = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    m = b * n
    weights = (4 if f32 else 2) * macs + 4 * (3 * sum(hidden) + out)
    feats = 4 * m * out if emit else 0
    kv = 3 * 4 * m // kv_pool * out if kv_pool else 0
    if backward:
        flops = 6.0 * m * macs
        nbytes = 4 * m * d + weights + feats + kv + 4 * (
            macs + 3 * sum(hidden) + out) + 4 * m * d
    else:
        flops = 2.0 * m * macs
        nbytes = 4 * m * d + weights + feats + kv
    return _bound(flops, nbytes, f32)


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
        remat_plan,
    )

    rng = np.random.default_rng(6)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    bf = torch.bfloat16
    result, peaks = {}, {}
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
        plan = remat_plan(b * n, 8, hidden, out, bf)
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
        print(f"K5 bwd {name} ({b}, {n}): {len(plan['chunks'])} chunk(s) "
              f"of {plan['chunk_rows']} rows", flush=True)
        if b * n <= 8 * 2560 and len(plan["chunks"]) != 1:
            raise AssertionError(f"K5 bwd {name}: more than one chunk")
        if len(plan["chunks"]) > 1:
            one = remat_chain_backward(x, stages, fw, fb, **bkw, **ONE_CHUNK)
            k5_chunks_equal(torch, f"K5 bwd {name} ({b}, {n})", gk, one,
                            k5_close(f"K5 bwd {name} dW, {len(plan['chunks'])}"
                                     f" chunks vs one"))
            del one
        if name == "ragged kv":
            forced = remat_plan(b * n, 8, hidden, out, bf, **FORCED_CHUNKS)
            gf = remat_chain_backward(x, stages, fw, fb, **bkw,
                                      **FORCED_CHUNKS)
            label = (f"K5 bwd {name} ({b}, {n}) forced into "
                     f"{len(forced['chunks'])} chunks {forced['chunks']}")
            k5_close(f"{label} vs plain")(gf, gp)
            k5_chunks_equal(torch, label, gf, remat_chain_backward(
                x, stages, fw, fb, **bkw, **ONE_CHUNK), k5_close(
                f"{label} dW vs one"))
            del gf
        if (b, n) in ((3, 2560), (128, 2560)):
            peaks[f"B={b} N={n}"] = k5_bwd_peak(
                torch, f"K5 bwd {name} ({b}, {n})", ("bf16", b, n), plan,
                lambda: remat_chain_backward(x, stages, fw, fb, **bkw), card)
            if len(plan["chunks"]) > 1:
                peaks[f"B={b} N={n} one chunk"] = k5_bwd_peak(
                    torch, f"K5 bwd {name} ({b}, {n}) in one chunk",
                    ("one chunk", b, n), remat_plan(
                        b * n, 8, hidden, out, bf, **ONE_CHUNK),
                    lambda: remat_chain_backward(x, stages, fw, fb, **bkw,
                                                 **ONE_CHUNK), card)

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
            if len(plan["chunks"]) > 1:
                ms = cuda_ms(torch, lambda: remat_chain_backward(
                    x, stages, fw, fb, **bkw), 10)
                one_ms = cuda_ms(torch, lambda: remat_chain_backward(
                    x, stages, fw, fb, **bkw, **ONE_CHUNK), 10)
                print(f"K5 backward time {name} ({b}, {n}), same call: "
                      f"{len(plan['chunks'])} chunks {ms:.3f} ms, one chunk "
                      f"{one_ms:.3f} ms [{card}]", flush=True)
                timed["backward"]["one_chunk_ms"] = one_ms
            if name == "parity features":
                result = timed
            elif name == "bench parity features":
                result["bench backward"] = timed["backward"]
        del x, got, want, k2, gk, gp
    result["backward"]["peak"] = peaks
    return result


# ---------------------------------------------------------------------------
# Training: the recipe train step
# ---------------------------------------------------------------------------

# The edge head's pair MLP kernel (csrc/pair_mlp.cu): (B, V) at the
# edge head's full width F = 512, bf16.  (512, 40) is the recipe's bulk
# inference batch, (3, 40) the shipped eval batch, (7, 64) the parity
# model's 64 slots, and (5, 23), 5 x 253 = 1265 pair rows, a last tile
# of 113 rows.
PAIR_MLP_SHAPES = ((512, 40), (3, 40), (7, 64), (5, 23))
PAIR_MLP_STEPS = 20
PAIR_MLP_FORWARDS = 5


def pair_mlp_bound_ms(b, v, f):
    """Least time for the pair MLP: its two products and the dot with w5
    at the bf16 peak, against u_i, u_j, x and the weights read once and
    the logits and probabilities written once."""
    e = v * (v - 1) // 2
    flops = 2.0 * b * e * (f * f // 2 + f // 2 * f // 4 + f // 4)
    nbytes = (2 * 2 * b * v * f + 2 * b * v * 3
              + 2 * (f * f // 2 + f // 2 * f // 4) + 4 * (6 * f) + 8 * b * e)
    return _bound(flops, nbytes, False)


# The PTv3 phase's bounds on the program against the benchmark's plain
# reference, both bf16 with f32 accumulation: the cell's correctness
# limits (port_bench/limits/ptv3-infer-b128-16k.json), which sit between
# the program's readings and those of a CPE left out and of fp8 operands.
PTV3_ATOL = {"vertices": 0.035, "existence_probabilities": 0.016,
             "edge_probs": 0.018}
PTV3_SPANS = ("serialize", "sparse_conv", "patch_attn", "grid_pool",
              "grid_unpool")


def ptv3_config(extra=()):
    """The benchmark's ptv3 configuration (the recipe with Point
    Transformer V3 as its backbone, published widths) as overrides."""
    with open(os.path.join(os.path.dirname(RECIPE), os.pardir,
                           "port_bench", "configs", "ptv3.json")) as f:
        model = json.load(f)["model"]
    sets = ["model.encoder=ptv3", "data.num_points=16384"]
    for k, v in model.items():
        if k.startswith("ptv3_"):
            sets.append(f"model.{k}=" + (",".join(map(str, v))
                                         if isinstance(v, list) else str(v)))
    from wireframe_tpu_torch.config import load_config

    return load_config(RECIPE, sets + list(extra))


def ptv3_split(torch, call, trace_dir, label, card, spans=PTV3_SPANS,
               model="ptv3"):
    """Profile one call: the backbone's five spans inside the encoder's,
    every launch found on the host (`tools/trace_ops`), device ms by
    span."""
    from torch.profiler import ProfilerActivity, profile

    from wireframe_tpu_torch.tools.trace_ops import (
        NO_SPAN,
        NOT_FOUND,
        aggregate_device_events,
    )

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "forward.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["name"][3:], e["ts"], e["ts"] + e.get("dur", 0))
              for e in events if str(e.get("name", "")).startswith("wf.")
              and e.get("cat") == "user_annotation"]
    enc = [(a, b) for n, a, b in ranges if n == "encoder"]
    assert len(enc) == 1, ranges
    for name in spans:
        inside = [(a, b) for n, a, b in ranges if n == name]
        assert inside and all(enc[0][0] <= a and b <= enc[0][1]
                              for a, b in inside), name
    totals, _, span_us, span_own = aggregate_device_events(trace_dir)
    lost = sum(span_own.get(NOT_FOUND, {}).values())
    assert lost == 0 and all(n in span_us for n in spans), (
        lost, sorted(span_us))
    print(f"{model} {label} device ms by span (inclusive, self; trace_ops; "
          "every launch found): "
          + ", ".join(f"{n} {span_us.get(n, 0) / 1e3:.2f} "
                      f"{sum(span_own.get(n, {}).values()) / 1e3:.2f}"
                      for n in ("encoder",) + spans
                      + ("vertex_head", "edge_head"))
          + f"; outside every span {span_us.get(NO_SPAN, 0) / 1e3:.2f}"
          f"; total {sum(totals.values()) / 1e3:.2f} [{card}]",
          flush=True)


# The submanifold conv kernel (csrc/subm_conv.cu): the convolutions of one
# ptv3 forward (the stem and 22 xCPE convs).
SUBM_CONVS = 23


def subm_conv_bound_ms(m, k, cin, cout, pairs, bias):
    """Least time for one convolution on capacity rows: the pairs that
    exist at the bf16 peak, against its input rows, its map at 4 bytes a
    slot, weights and bias read once and its outputs written once."""
    flops = 2.0 * pairs * cin * cout
    nbytes = 2 * m * cin + 4 * m * k + 2 * k * cin * cout + 2 * m * cout \
        + (2 * cout if bias else 0)
    return _bound(flops, nbytes, False)


def subm_conv_shapes(torch, card, model, fwd, xb):
    """Capture the inputs of every convolution of one forward on `xb`,
    then hold the kernel to its plain version on each: within twice the
    plain version's own gap to the same sums in f32, rows with no
    neighbour (the dummy rows) exactly equal; time both beside the
    bound.  Returns the per-conv records."""
    from wireframe_tpu_torch.models.ptv3 import SubMConv
    from wireframe_tpu_torch.ops import subm_conv

    bf16 = torch.bfloat16
    seen = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0], args[1])))
        for mod in model.modules() if isinstance(mod, SubMConv)]
    try:
        fwd(model, xb)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    if len(seen) != SUBM_CONVS:
        raise AssertionError(f"subm conv: {len(seen)} convolutions in a "
                             f"forward, not {SUBM_CONVS}")
    rows = []
    for i, (mod, x, nbr) in enumerate(seen):
        m, cin = x.shape
        k = nbr.shape[1]
        w, b = mod.weight, mod.bias
        cout = w.shape[0]
        with torch.inference_mode():
            got = subm_conv.subm_conv(x, nbr, w, b, dtype=bf16)
            want = subm_conv.subm_conv_plain(x, nbr, w, b, dtype=bf16)
            f32 = subm_conv.subm_conv_plain(
                x.to(bf16).float(), nbr, w.to(bf16).float(),
                None if b is None else b.to(bf16).float(),
                dtype=torch.float32)
            empty = (nbr == m).all(1)
            pairs = int((nbr < m).sum())
            kernel_vs_plain = float((got.float() - want.float()).abs().max())
            own = float((want.float() - f32).abs().max())
            kernel_vs_f32 = float((got.float() - f32).abs().max())
            empty_equal = bool(torch.equal(got[empty], want[empty]))
            ms = cuda_ms(torch, lambda: subm_conv.subm_conv(
                x, nbr, w, b, dtype=bf16), 10)
            plain_ms = cuda_ms(torch, lambda: subm_conv.subm_conv_plain(
                x, nbr, w, b, dtype=bf16), 3)
        bound, by = subm_conv_bound_ms(m, k, cin, cout, pairs, b is not None)
        row = {"conv": i, "shape": f"M={m} K={k} CIN={cin} COUT={cout}",
               "pairs": pairs, "empty_rows": int(empty.sum()), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "pct_of_bound": 100.0 * bound / ms,
               "kernel_vs_plain": kernel_vs_plain, "plain_vs_f32": own,
               "kernel_vs_f32": kernel_vs_f32}
        rows.append(row)
        print(f"subm conv {i} ({m}, K={k}, {cin} -> {cout}): {pairs} pairs, "
              f"{row['empty_rows']} rows with no neighbour; kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{row['pct_of_bound']:.1f}% of bound; kernel vs plain "
              f"{kernel_vs_plain}, plain vs f32 {own}, kernel vs f32 "
              f"{kernel_vs_f32} [{card}]", flush=True)
        if not (kernel_vs_plain <= 2 * own and empty_equal):
            raise AssertionError(
                f"subm conv {i}: kernel against the plain version "
                f"{kernel_vs_plain} over 2x the plain version's own gap to "
                f"f32 {own}, or rows with no neighbour not equal "
                f"({empty_equal})")
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms")}
    print(f"subm conv, the {SUBM_CONVS} convolutions of a call: kernel "
          f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, bound "
          f"{total['bound_ms']:.4f} ms, "
          f"{100.0 * total['bound_ms'] / total['ms']:.2f}% of bound "
          f"[{card}]", flush=True)
    return rows


# The neighbour map kernel (csrc/neighbour_map.cu): the maps of one ptv3
# forward (the stem's size 5 on level 0, then a size 3 on each of the five
# levels for its xCPE convs).
NEIGHBOUR_MAPS = 6


def neighbour_map_bound_ms(m, k):
    """Least time for one map on M capacity rows: the level's key, grid,
    batch and valid read once (41 bytes a row), the map written once."""
    return _bound(0.0, 41 * m + 8 * m * k, False)


def captured_maps(torch, call):
    """((key, grid, batch, valid, size), (nbr, pairs)) of each neighbour
    map that one `call()` builds, in order."""
    from wireframe_tpu_torch.ops import voxel

    seen = []
    real = voxel.neighbour_map

    def capture(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    with mock.patch.object(voxel, "neighbour_map", capture):
        call()
        torch.cuda.synchronize()
    if len(seen) != NEIGHBOUR_MAPS:
        raise AssertionError(f"neighbour map: {len(seen)} maps in a "
                             f"forward, not {NEIGHBOUR_MAPS}")
    return seen


def neighbour_map_shapes(torch, card, call, label):
    """Hold the kernel's map and pairs at every map of one `call()` to
    `neighbour_map_plain` on the same tensors (`torch.equal`); time both
    beside the bound; print the hit share (pairs over capacity rows x
    offsets).  Returns the per-map records."""
    from wireframe_tpu_torch.ops import voxel

    rows = []
    for i, (args, (nbr, pairs)) in enumerate(captured_maps(torch, call)):
        key, grid, batch, valid, size = args
        m, k = nbr.shape
        with torch.inference_mode():
            want, want_pairs = voxel.neighbour_map_plain(*args)
            equal = (torch.equal(nbr, want)
                     and int(pairs) == int(want_pairs))
            del want
            ms = cuda_ms(torch, lambda: voxel.neighbour_map(*args), 10)
            plain_ms = cuda_ms(torch, lambda: voxel.neighbour_map_plain(
                *args), 3)
        bound, _ = neighbour_map_bound_ms(m, k)
        row = {"map": i, "shape": f"M={m} K={k}", "valid": int(valid.sum()),
               "pairs": int(pairs), "hit_pct": 100.0 * int(pairs) / (m * k),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "pct_of_bound": 100.0 * bound / ms, "equal": equal}
        rows.append(row)
        print(f"neighbour map {label} {i} (M={m}, K={k}, {row['valid']} "
              f"valid rows): {row['pairs']} pairs, hit share "
              f"{row['hit_pct']:.2f}% of M x K; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms, "
              f"{row['pct_of_bound']:.1f}% of bound; torch.equal to the "
              f"plain map with equal pairs: {equal} [{card}]", flush=True)
        if not equal:
            raise AssertionError(f"neighbour map {label} {i}: the kernel's "
                                 "map or pairs differ from the plain "
                                 "version's")
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms")}
    print(f"neighbour map {label}, the {NEIGHBOUR_MAPS} maps of a call: "
          f"kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
          f"bound {total['bound_ms']:.4f} ms, "
          f"{100.0 * total['bound_ms'] / total['ms']:.2f}% of bound "
          f"[{card}]", flush=True)
    return rows


def ptv3_phase(torch, dev, card, work):
    """Point Transformer V3 as the recipe's backbone at its published
    widths: the forward at (8, 16384) against the benchmark's plain
    reference, with no host synchronisation (CUDA sync debug mode
    "error"), the five spans inside the encoder span, the device
    counters, ms and peak memory of one call at (8, 16384) and (128,
    16384) with one pair MLP kernel launch a forward; a call over a
    stage's capacity raises on readback and the next call is served; one
    train step at (2, 4096) with every backbone parameter's Adam moment
    finite and nonzero; at (8, 16384) and (128, 16384) every neighbour
    map held to its plain version (`neighbour_map_shapes`), and the (128,
    16384) forward under sync debug mode too.  Returns the gaps, the pair
    MLP's launches over the timed forwards and the per-map records."""
    from port_bench.drivers.common import FORWARD_KEYS, forward_gaps
    from port_bench.drivers.infer_ptv3 import build_model, ptv3_batch
    from port_bench.reference import ptv3 as ref_ptv3
    from port_bench.reference.model import Precision
    from wireframe_tpu_torch.models.ptv3 import (
        CapacityOverflow,
        capacity_rows,
        raise_on_overflow,
    )
    from wireframe_tpu_torch.train.step import make_forward_fn

    t0 = time.perf_counter()
    cfg = ptv3_config()
    rng = np.random.default_rng(21)
    model, weights = build_model(cfg, 21, dev)
    model.eval()
    fwd = make_forward_fn(cfg)
    x = torch.from_numpy(ptv3_batch(rng, 8, 16384, 0.25)).to(dev)
    out = fwd(model, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fwd(model, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    prog = {k: out[k].float().cpu().numpy() for k in FORWARD_KEYS}
    m = dataclasses.asdict(cfg.model)
    p = Precision(torch.bfloat16)
    with torch.no_grad():
        ref = ref_ptv3.forward(p, weights, m, x)
    gaps = forward_gaps(prog, ref, x.shape[0])
    print(f"ptv3 (8, 16384) against the reference: {gaps} [{card}]",
          flush=True)
    for key, name in (("vertices", "vertex_gap"),
                      ("existence_probabilities", "exist_gap"),
                      ("edge_probs", "edge_gap")):
        assert gaps[name] <= PTV3_ATOL[key], (name, gaps[name])
    assert gaps["count_self_gap"] == 0

    ptv3_split(torch, lambda: fwd(model, x), os.path.join(work, "ptv3_8"),
               "(8, 16384)", card)
    forwards, launches, convs, maps = 0, 0, {}, {}
    ptv3_rows = {b: [capacity_rows(f, b * 16384)
                     for f in cfg.model.ptv3_capacity] for b in (8, 128)}
    for b in (8, 128):
        xb = torch.from_numpy(ptv3_batch(rng, b, 16384, 0.25)).to(dev)
        fwd(model, xb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        model.encoder.backbone.reset_counters()
        calls = [0]

        def timed():
            calls[0] += 1
            return fwd(model, xb)

        keys = ("pair MLP", "subm conv", "neighbour map")
        before = launch_counts(keys)
        ms = cuda_ms(torch, timed, 3)
        launched, conv_launched, map_launched = (
            launch_counts(keys)[k] - before[k] for k in keys)
        if (launched != calls[0]
                or conv_launched != SUBM_CONVS * calls[0]
                or map_launched != NEIGHBOUR_MAPS * calls[0]):
            raise AssertionError(f"ptv3 ({b}, 16384): {launched} pair MLP, "
                                 f"{conv_launched} subm conv and "
                                 f"{map_launched} neighbour map launches "
                                 f"in {calls[0]} forwards")
        forwards += calls[0]
        launches += launched
        c = model.encoder.backbone.counters()
        steps = c["conv_steps_run"] + c["conv_steps_skipped"]
        skipped = 100.0 * c["conv_steps_skipped"] / steps
        hits = [100.0 * c[f"conv_pairs.{n}"] / (c["calls"] * m * k)
                for n, m, k in [("stem", ptv3_rows[b][0], 125)]
                + [(f"stage{i}", r, 27) for i, r in enumerate(ptv3_rows[b])]]
        maps[b] = neighbour_map_shapes(torch, card, lambda: fwd(model, xb),
                                       f"({b}, 16384)")
        if b == 128:
            torch.cuda.set_sync_debug_mode("error")
            try:
                fwd(model, xb)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ptv3_split(torch, lambda: fwd(model, xb),
                       os.path.join(work, "ptv3_128"), "(128, 16384)", card)
            convs = {"rows": subm_conv_shapes(torch, card, model, fwd, xb),
                     "launches": conv_launched, "forwards": calls[0],
                     "skipped_pct": skipped}
        print(f"ptv3 forward ({b}, 16384): {ms:.2f} ms, "
              f"{1e3 * b / ms:.1f} clouds/s, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, "
              f"rows a call by stage "
              f"{[c[f'rows.stage{i}'] // c['calls'] for i in range(5)]}, "
              f"padding {100 * c['attn_padded_rows'] / c['attn_real_rows']:.2f}"
              f" % of attention rows, dropped by grid sampling "
              f"{100 * c['grid_dropped'] / c['input_rows']:.1f} %, pair MLP "
              f"launches {launched}, subm conv launches {conv_launched} "
              f"and neighbour map launches {map_launched} in {calls[0]} "
              f"forwards, subm conv steps skipped "
              f"{c['conv_steps_skipped']} of {steps} ({skipped:.2f} %), "
              f"map hit share (conv_pairs over capacity rows x offsets: "
              f"stem, stages 0-4) {[round(h, 2) for h in hits]} %"
              f" [{card}]", flush=True)
        # Kernels a forward, on the device: one pair MLP, one per conv,
        # a table build and a lookup pass per map.
        kernels = device_launches(torch, lambda: fwd(model, xb),
                                  ("pair_mlp_kernel", "subm_conv_kernel",
                                   "nbr_table_kernel", "nbr_query_kernel"))
        print(f"ptv3 ({b}, 16384): device kernels in one forward "
              f"{kernels} [{card}]", flush=True)
        assert kernels == {"pair_mlp_kernel": 1,
                           "subm_conv_kernel": SUBM_CONVS,
                           "nbr_table_kernel": NEIGHBOUR_MAPS,
                           "nbr_query_kernel": NEIGHBOUR_MAPS}, kernels
        del xb

    # A stage over its capacity: the call raises when its outputs are
    # read, and the process and its CUDA context serve the next call.
    small = ptv3_config([f"model.ptv3_capacity={','.join(['0.02'] * 5)}"])
    smodel, _ = build_model(small, 21, dev)
    smodel.eval()
    sfwd = make_forward_fn(small)
    try:
        raise_on_overflow(sfwd(smodel, x))
        raise AssertionError("ptv3: a call over capacity did not raise")
    except CapacityOverflow:
        pass
    tiny = torch.zeros_like(x)
    tiny[:, :64] = x[:, :64]
    after = sfwd(smodel, tiny)
    raise_on_overflow(after)
    assert bool(torch.isfinite(after["vertices"]).all())
    print(f"ptv3 capacity 0.02: (8, 16384) raised CapacityOverflow on "
          f"readback, then (8, 64 points) served [{card}]", flush=True)
    del smodel

    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.synth import make_random_batch

    tcfg = ptv3_config(["data.num_points=4096", "train.batch_size=2",
                        "model.ptv3_capacity=1,1,1,1,1",
                        "train.weight_decay=0", "train.lr_schedule=constant"])
    tmodel, _ = build_model(tcfg, 22, dev)
    tmodel.train()
    state = create_train_state(tcfg, tmodel)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in make_random_batch(tcfg, 2).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    state, met = make_train_step(tcfg)(state, batch, gen)
    loss = float(met["total_loss"])
    names = [k for k in state.mu if k.startswith("encoder.backbone.")]
    bad = [k for k in names if not bool(torch.isfinite(state.mu[k]).all())
           or not bool(state.mu[k].abs().sum() > 0)]
    assert math.isfinite(loss) and not bad, (loss, bad[:5])
    print(f"ptv3 train step (2, 4096): loss {loss:.4f}, "
          f"{len(names)} backbone parameters with a finite nonzero "
          f"gradient; phase {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return {"gaps": gaps, "pair_mlp_launches": launches,
            "forwards": forwards, "subm_conv": convs, "neighbour_map": maps}


# The PTv2 phase's bounds on the program against the benchmark's plain
# reference, both bf16 with f32 accumulation: the cell's correctness
# limits (port_bench/limits/ptv2-infer-b128-16k.json).
PTV2_LIMITS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "port_bench", "limits", "ptv2-infer-b128-16k.json")
PTV2_SPANS = ("grid_sample", "knn", "gva", "grid_pool", "grid_unpool")
# kNN searches a ptv2 forward: one a level (the patch embed's and the
# four encoder stages').
KNN_SEARCHES = 5


def ptv2_config(extra=()):
    """The benchmark's ptv2 configuration (the recipe with Point
    Transformer V2 as its backbone, published widths) as overrides."""
    with open(os.path.join(os.path.dirname(RECIPE), os.pardir,
                           "port_bench", "configs", "ptv2.json")) as f:
        model = json.load(f)["model"]
    sets = ["model.encoder=ptv2", "data.num_points=16384"]
    for k, v in model.items():
        if k.startswith("ptv2_"):
            sets.append(f"model.{k}=" + (",".join(map(str, v))
                                         if isinstance(v, list) else str(v)))
    from wireframe_tpu_torch.config import load_config

    return load_config(RECIPE, sets + list(extra))


def knn_bound_ms(m, k):
    """Least time for one search on M capacity rows: the coordinates,
    cloud id and validity read once (21 bytes a row), the indices
    written once (8 bytes a slot)."""
    return _bound(0.0, 21 * m + 8 * m * k, False)


def knn_shapes(torch, card, call, label):
    """Hold the kernel's indices at every kNN search of one `call()` to
    `knn_plain` on the same tensors (`torch.equal`); time both beside the
    bound.  Returns the per-level records."""
    from wireframe_tpu_torch.ops import knn as knn_op

    seen = []
    real = knn_op.knn

    def capture(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    with mock.patch.object(knn_op, "knn", capture):
        call()
        torch.cuda.synchronize()
    if len(seen) != KNN_SEARCHES:
        raise AssertionError(f"knn: {len(seen)} searches in a forward, not "
                             f"{KNN_SEARCHES}")
    rows = []
    for level, (args, got) in enumerate(seen):
        xyz, batch, offsets, k = args
        m = xyz.shape[0]
        with torch.inference_mode():
            want = knn_op.knn_plain(*args)
            equal = bool(torch.equal(got, want))
            real_slots = int((got >= 0).sum())
            del want
            ms = cuda_ms(torch, lambda: knn_op.knn(*args), 10)
            plain_ms = cuda_ms(torch, lambda: knn_op.knn_plain(*args), 1)
        bound, _ = knn_bound_ms(m, k)
        row = {"level": level, "shape": f"M={m} K={k}",
               "valid": int(offsets[-1]), "real_slots": real_slots,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "pct_of_bound": 100.0 * bound / ms, "equal": equal}
        rows.append(row)
        print(f"knn {label} level {level} (M={m}, K={k}, {row['valid']} "
              f"real rows, {real_slots} real slots): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms, "
              f"{row['pct_of_bound']:.2f}% of bound; torch.equal to the "
              f"plain version: {equal} [{card}]", flush=True)
        if not equal:
            raise AssertionError(f"knn {label} level {level}: the kernel's "
                                 "indices differ from the plain version's")
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms")}
    print(f"knn {label}, the {KNN_SEARCHES} searches of a call: kernel "
          f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, bound "
          f"{total['bound_ms']:.4f} ms, "
          f"{100.0 * total['bound_ms'] / total['ms']:.2f}% of bound "
          f"[{card}]", flush=True)
    return rows


# GVAs a ptv2 forward: the patch embed's 1, the encoder's 2 + 2 + 6 + 2
# and the decoder's 4 blocks.
GVA_CALLS = 17
# The largest gap of the GVA kernel's output to its plain version's, both
# bf16 (the plain version's own gap to float32 is printed beside it).
GVA_GAP = 0.01


def gva_bound_ms(m, c, g, k, real_slots):
    """Least time for one GVA on M capacity rows: the products on the
    real neighbour slots (pe1, pe2, we1, we2 and the weighted sum) at the
    bf16 peak, or q, k and v read once in bf16, xyz (12 bytes a row), the
    indices (8 bytes a slot), the weights once (f32) and the output
    written once (f32) at HBM rate."""
    flops = 2.0 * real_slots * (3 * c + c * c + c * g + g * g + c)
    nbytes = (m * (3 * 2 * c + 12 + 8 * k + 4 * c)
              + 4 * (c * c + g * c + g * g + 20 * c + 6 * g))
    return _bound(flops, nbytes, False)


def gva_shapes(torch, card, call, label):
    """Hold the GVA kernel's output at every GVA of one `call()` to
    `gva_plain` on the same inputs (bf16; the largest gap within
    GVA_GAP), with the plain version's own gap to float32 beside it, and
    its counters to the level's real slots, slots and the rows of warps
    without a neighbour; time both beside the bound.  Returns the
    per-call records."""
    from wireframe_tpu_torch.ops import gva as gva_op

    seen = []
    real = gva_op.gva

    def capture(attn, level, x, k, dt, counters=None):
        probe = torch.zeros(3, dtype=torch.int64, device=x.device)
        out = real(attn, level, x, k, dt, probe)
        if counters is not None:
            counters.add_(probe)
        seen.append((attn, level, x, k, dt, out, probe))
        return out

    with mock.patch.object(gva_op, "gva", capture):
        call()
        torch.cuda.synchronize()
    if len(seen) != GVA_CALLS:
        raise AssertionError(f"gva: {len(seen)} calls in a forward, not "
                             f"{GVA_CALLS}")
    rows = []
    for n, (attn, level, x, k, dt, got, probe) in enumerate(seen):
        m, c = x.shape
        g = attn.groups
        with torch.inference_mode():
            want = gva_op.gva_plain(attn, level, x, k, dt)
            f32 = gva_op.gva_plain(attn, level, x, k, torch.float32)
            gap = float((got - want).abs().max())
            own = float((want - f32).abs().max())
            scale = float(want.abs().max())
            del want, f32
            has = level.nbr[:, :k] >= 0
            real_slots = int((has & level.valid[:, None]).sum())
            # The rows of warps (16 / k query rows each) none of whose
            # rows has a neighbour: the ones the kernel skips.
            per = 16 // k
            pad = torch.ones(-(-m // per) * per, dtype=torch.bool,
                             device=x.device)
            pad[:m] = ~has.any(1)
            dead = int(pad.view(-1, per).all(1).repeat_interleave(per)[:m]
                       .sum())
            ms = cuda_ms(torch, lambda: gva_op.gva(attn, level, x, k, dt),
                         10)
            plain_ms = cuda_ms(torch, lambda: gva_op.gva_plain(
                attn, level, x, k, dt), 1)
        bound, by = gva_bound_ms(m, c, g, k, real_slots)
        row = {"call": n, "shape": f"M={m} C={c} G={g} k={k}",
               "real_slots": real_slots, "counted": probe.tolist(),
               "skipped": int(probe[2]),
               "dead_rows": dead, "gap": gap, "plain_vs_f32": own,
               "scale": scale, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by,
               "pct_of_bound": 100.0 * bound / ms}
        rows.append(row)
        print(f"gva {label} call {n} ({row['shape']}, {real_slots} real "
              f"slots, {dead} rows in warps without a neighbour, counted "
              f"{row['counted']}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}), "
              f"{row['pct_of_bound']:.2f}% of "
              f"bound; largest gap to the plain version {gap:.3e} (limit "
              f"{GVA_GAP}), the plain version's to f32 {own:.3e}, largest "
              f"|out| {scale:.3f} [{card}]", flush=True)
        if not gap <= GVA_GAP or row["counted"] != [real_slots, m * k,
                                                     dead]:
            raise AssertionError(f"gva {label} call {n}: gap {gap} over "
                                 f"{GVA_GAP}, or counted {row['counted']} "
                                 f"(real slots, slots, rows skipped), not "
                                 f"{[real_slots, m * k, dead]}")
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms")}
    print(f"gva {label}, the {GVA_CALLS} GVAs of a call: kernel "
          f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, bound "
          f"{total['bound_ms']:.4f} ms, "
          f"{100.0 * total['bound_ms'] / total['ms']:.2f}% of bound "
          f"[{card}]", flush=True)
    return rows


def ptv2_phase(torch, dev, card, work):
    """Point Transformer V2 as the recipe's backbone at its published
    widths: at (8, 16384) and (128, 16384) every kNN search and every GVA
    held to its plain version (`knn_shapes`, `gva_shapes`), 5 kNN and 17
    GVA launches a forward in the launch registry and 5 `knn_kernel`, 17
    `gva_kernel` (and one `pair_mlp_kernel`) in a profile,
    the forward under CUDA's sync debug mode "error", ms, peak memory and
    the device counters; at (8, 16384) the forward against the
    benchmark's plain reference within the cell's limits and the five
    spans inside the encoder's; a call over a level's capacity raises on
    readback and the next call is served; `make_train_step` refuses the
    configuration.  Returns the gaps and the per-search records."""
    from port_bench.drivers.common import FORWARD_KEYS, forward_gaps
    from port_bench.drivers.infer_ptv3 import build_model, ptv3_batch
    from port_bench.reference import ptv2 as ref_ptv2
    from port_bench.reference.model import Precision
    from wireframe_tpu_torch.models.ptv3 import (
        CapacityOverflow,
        capacity_rows,
        raise_on_overflow,
    )
    from wireframe_tpu_torch.train.step import make_forward_fn

    t0 = time.perf_counter()
    with open(PTV2_LIMITS) as f:
        limits = {k: v for k, v in json.load(f).items()
                  if not k.startswith("_")}
    cfg = ptv2_config()
    rng = np.random.default_rng(23)
    model, weights = build_model(cfg, 23, dev)
    model.eval()
    fwd = make_forward_fn(cfg)
    searches, gvas, forwards = {}, {}, 0
    gaps = None
    for b in (8, 128):
        xb = torch.from_numpy(ptv3_batch(rng, b, 16384, 0.25)).to(dev)
        out = fwd(model, xb)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fwd(model, xb)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if b == 8:
            prog = {k: out[k].float().cpu().numpy() for k in FORWARD_KEYS}
            m = dataclasses.asdict(cfg.model)
            p = Precision(torch.bfloat16)
            with torch.no_grad(), p.matmul_mode():
                ref = ref_ptv2.forward(p, weights, m, xb)
            gaps = forward_gaps(prog, ref, b)
            print(f"ptv2 (8, 16384) against the reference: {gaps}, limits "
                  f"{limits} [{card}]", flush=True)
            bad = {k: v for k, v in gaps.items() if v > limits[k]}
            assert not bad, bad
            ptv3_split(torch, lambda: fwd(model, xb),
                       os.path.join(work, "ptv2_8"), "(8, 16384)", card,
                       PTV2_SPANS, "ptv2")
        torch.cuda.reset_peak_memory_stats(dev)
        model.encoder.backbone.reset_counters()
        calls = [0]

        def timed():
            calls[0] += 1
            return fwd(model, xb)

        keys = ("pair MLP", "knn", "gva")
        before = launch_counts(keys)
        ms = cuda_ms(torch, timed, 3)
        pair, knn, gva = (launch_counts(keys)[k] - before[k] for k in keys)
        if (pair != calls[0] or knn != KNN_SEARCHES * calls[0]
                or gva != GVA_CALLS * calls[0]):
            raise AssertionError(f"ptv2 ({b}, 16384): {pair} pair MLP, "
                                 f"{knn} knn and {gva} gva launches in "
                                 f"{calls[0]} forwards")
        forwards += calls[0]
        c = model.encoder.backbone.counters()
        caps = [capacity_rows(f, b * 16384) for f in cfg.model.ptv2_capacity]
        print(f"ptv2 forward ({b}, 16384): {ms:.2f} ms, "
              f"{1e3 * b / ms:.1f} clouds/s, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, "
              f"rows a call by level "
              f"{[c[f'rows.level{i}'] // c['calls'] for i in range(5)]} of "
              f"{caps}, most {[c[f'rows_max.level{i}'] for i in range(5)]}, "
              f"GVA slots real {c['gva_real_slots'] // c['calls']} of "
              f"{c['gva_slots'] // c['calls']} a call, GVA rows skipped "
              f"{c['gva_rows_skipped'] // c['calls']} a call, dropped by "
              f"grid sampling {100 * c['grid_dropped'] / c['input_rows']:.1f}"
              f" %, pair MLP launches {pair}, knn launches {knn} and gva "
              f"launches {gva} in {calls[0]} forwards [{card}]", flush=True)
        searches[b] = knn_shapes(torch, card, lambda: fwd(model, xb),
                                 f"({b}, 16384)")
        gvas[b] = gva_shapes(torch, card, lambda: fwd(model, xb),
                             f"({b}, 16384)")
        kernels = device_launches(torch, lambda: fwd(model, xb),
                                  ("pair_mlp_kernel", "knn_kernel",
                                   "gva_kernel"))
        print(f"ptv2 ({b}, 16384): device kernels in one forward "
              f"{kernels} [{card}]", flush=True)
        assert kernels == {"pair_mlp_kernel": 1, "knn_kernel": KNN_SEARCHES,
                           "gva_kernel": GVA_CALLS}, kernels
        del xb, out

    small = ptv2_config([f"model.ptv2_capacity={','.join(['0.02'] * 5)}"])
    smodel, _ = build_model(small, 23, dev)
    smodel.eval()
    sfwd = make_forward_fn(small)
    x = torch.from_numpy(ptv3_batch(rng, 8, 16384, 0.25)).to(dev)
    try:
        raise_on_overflow(sfwd(smodel, x))
        raise AssertionError("ptv2: a call over capacity did not raise")
    except CapacityOverflow:
        pass
    tiny = torch.zeros_like(x)
    tiny[:, :64] = x[:, :64]
    after = sfwd(smodel, tiny)
    raise_on_overflow(after)
    assert bool(torch.isfinite(after["vertices"]).all())
    print(f"ptv2 capacity 0.02: (8, 16384) raised CapacityOverflow on "
          f"readback, then (8, 64 points) served [{card}]", flush=True)
    del smodel

    from wireframe_tpu_torch.train.step import make_train_step

    try:
        make_train_step(cfg)
        raise AssertionError("ptv2: make_train_step built a step")
    except ValueError as e:
        assert "X-ptv2-train" in str(e), e
    print(f"ptv2 train step refused at build; phase "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return {"gaps": gaps, "forwards": forwards, "knn": searches,
            "gva": gvas}


def pair_mlp_phase(torch, dev, card, work):
    """The pair MLP kernel against its plain version at PAIR_MLP_SHAPES,
    with a bound from the plain version's own gap to the same math in f32;
    its time beside the plain version's and its bound; one launch per
    served recipe forward, whose edge probabilities are held to the eager
    path's; none in 20 recipe and 20 parity train steps.  Returns the
    kernel's figures at (512, 40)."""
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.models.edge_head import EdgePredictor
    from wireframe_tpu_torch.ops import pair_mlp
    from wireframe_tpu_torch.train.loop import init_model, train_model
    from wireframe_tpu_torch.train.step import make_forward_fn
    from wireframe_tpu_torch.utils.synth import make_box_building_batch

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(20)
    head = EdgePredictor(vertex_dim=3, hidden_dim=512, num_heads=8,
                         slot_feature_dim=256, dtype=bf16)
    with torch.no_grad():
        # Off the init's zeros and ones, so that a swapped term shows.
        for name, prm in head.named_parameters():
            if name.endswith("bias") or name.startswith("LayerNorm"):
                prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
    head = head.to(dev).eval()
    p = head.pair_params()
    out = {}
    for b, v in PAIR_MLP_SHAPES:
        verts = torch.randn((b, v, 3), generator=gen).to(dev)
        feats = torch.randn((b, v, 256), generator=gen).to(dev)
        live = (torch.rand((b, v), generator=gen) > 0.3).to(dev)
        plan = pair_mlp.pair_mlp_plan(b, v, 512)
        with torch.inference_mode():
            x, ui, uj = head.slot_rows(verts, torch.ones_like(live), feats)
            n0 = launch_counts(PAIR)["pair MLP"]
            kp, kl, km = pair_mlp.pair_mlp(ui, uj, x, live, p, dtype=bf16)
            torch.cuda.synchronize()
            launched = launch_counts(PAIR)["pair MLP"] - n0
            pp, pl, pm = pair_mlp.pair_mlp_plain(ui, uj, x, live, p,
                                                 dtype=bf16)
            fp, fl, _ = pair_mlp.pair_mlp_plain(
                ui.float(), uj.float(), x.float(), live, p,
                dtype=torch.float32)
        if launched != 1 or not torch.equal(km, pm):
            raise AssertionError(f"pair MLP ({b}, {v}): {launched} launches, "
                                 f"pair mask equal {torch.equal(km, pm)}")

        def gap(a, c):
            return float((a.float() - c.float()).abs().max())

        row = {"rows": plan["rows"], "tiles": plan["tiles"],
               "last_tile_rows": plan["last_tile_rows"]}
        for name, k, pl_, f_ in (("probs", kp, pp, fp),
                                 ("logits", kl, pl, fl)):
            own = gap(pl_, f_)
            row[name] = {"kernel_vs_plain": gap(k, pl_),
                         "plain_vs_f32": own, "kernel_vs_f32": gap(k, f_),
                         "bound": 2 * own}
        print(f"pair MLP ({b}, {v}): {plan['rows']} rows, {plan['tiles']} "
              f"tiles (last {plan['last_tile_rows']} rows), grid "
              f"{plan['grid']}; probs {row['probs']}; logits "
              f"{row['logits']} [{card}]", flush=True)
        for name in ("probs", "logits"):
            r = row[name]
            if not r["kernel_vs_plain"] <= r["bound"]:
                raise AssertionError(
                    f"pair MLP ({b}, {v}) {name}: kernel against the plain "
                    f"version {r['kernel_vs_plain']} over 2x the plain "
                    f"version's own gap to f32, {r['bound']}")
        if (b, v) == PAIR_MLP_SHAPES[0]:
            with torch.inference_mode():
                ms = cuda_ms(torch, lambda: pair_mlp.pair_mlp(
                    ui, uj, x, live, p, dtype=bf16), 20)
                plain_ms = cuda_ms(torch, lambda: pair_mlp.pair_mlp_plain(
                    ui, uj, x, live, p, dtype=bf16), 3)
            bound, by = pair_mlp_bound_ms(b, v, 512)
            out = {**row, "shape": f"B={b} V={v} F=512", "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "pct_of_bound": 100.0 * bound / ms}
            print(f"pair MLP ({b}, {v}) time: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                  f"{100.0 * bound / ms:.1f}% of bound [{card}]", flush=True)

    # The served recipe forward: one launch a call, counted on the device
    # by name, its edge probabilities held to the same forward through the
    # eager ops.
    cfg = load_config(RECIPE)
    model = init_model(cfg, dev, seed=SERVE_SEED).eval()
    forward = make_forward_fn(cfg)
    rng = np.random.default_rng(20)
    clouds = torch.from_numpy(padded_clouds(rng, 8, cfg.data.num_points)
                              ).to(dev)
    n0 = launch_counts(PAIR)["pair MLP"]
    for _ in range(PAIR_MLP_FORWARDS):
        got = forward(model, clouds)
    torch.cuda.synchronize()
    served = launch_counts(PAIR)["pair MLP"] - n0
    with torch.inference_mode(), mock.patch.object(
            pair_mlp, "engages", lambda *a: False):
        eager = model(clouds, train=False)
    torch.cuda.synchronize()
    if launch_counts(PAIR)["pair MLP"] - n0 != served:
        raise AssertionError("the eager forward took the kernel")
    kernels = device_launches(torch, lambda: forward(model, clouds),
                              ("pair_mlp_kernel",))["pair_mlp_kernel"]
    live = got["pair_mask"] & eager["pair_mask"]
    model_gap = float((got["edge_probs"] - eager["edge_probs"]
                       )[live].abs().max()) if live.any() else 0.0
    print(f"pair MLP served: {served} launches over {PAIR_MLP_FORWARDS} "
          f"recipe forwards at (8, {cfg.data.num_points}), {kernels} "
          f"pair_mlp_kernel on the device in one; edge_probs "
          f"against the eager path {model_gap} where both masks are live "
          f"({int(live.sum())} pairs; atol {MODEL_ATOL['edge_probs']})",
          flush=True)
    if served != PAIR_MLP_FORWARDS or kernels != 1 or not \
            model_gap <= MODEL_ATOL["edge_probs"]:
        raise AssertionError(f"pair MLP served: {served} launches, "
                             f"{kernels} device kernels, gap {model_gap}")

    # A width the kernel is not built for takes the eager path (ROADMAP
    # C7): one served forward at edge_hidden_dim 1024, no launch.
    wide = load_config(RECIPE, ["model.edge_hidden_dim=1024"])
    n0 = launch_counts(PAIR)["pair MLP"]
    probs = make_forward_fn(wide)(init_model(wide, dev, seed=SERVE_SEED)
                                  .eval(), clouds)["edge_probs"]
    wide_launches = launch_counts(PAIR)["pair MLP"] - n0
    finite = bool(torch.isfinite(probs).all())
    print(f"pair MLP at edge_hidden_dim 1024: served forward at (8, "
          f"{wide.data.num_points}), {wide_launches} pair MLP launches, "
          f"edge_probs {tuple(probs.shape)}, finite {finite} [{card}]",
          flush=True)
    assert not wide_launches and finite and (
        probs.shape == got["edge_probs"].shape), (wide_launches, finite)

    # Training takes the eager path: no launch in 20 steps of each model.
    trained = {}
    for tag, yaml, sets in (("recipe", RECIPE, []),
                            ("parity", PARITY, PARITY_SET)):
        tcfg = load_config(yaml, sets + [
            "train.overfit_one_batch=true", "train.log_every=1",
            f"train.num_epochs={PAIR_MLP_STEPS}",
            f"train.checkpoint_dir={os.path.join(work, 'pair_mlp_' + tag)}"])
        batch = make_box_building_batch(tcfg, tcfg.train.batch_size, seed=0)
        n0 = launch_counts(PAIR)["pair MLP"]
        train_model(tcfg, [batch], metric_writer=_Losses(), device=dev)
        torch.cuda.synchronize()
        trained[tag] = launch_counts(PAIR)["pair MLP"] - n0
    print(f"pair MLP launches over {PAIR_MLP_STEPS} train steps: {trained}",
          flush=True)
    if any(trained.values()):
        raise AssertionError(f"a train step launched the pair MLP kernel: "
                             f"{trained}")
    return {**out, "served_launches": served,
            "served_forwards": PAIR_MLP_FORWARDS, "train_launches": trained,
            "served_edge_gap": model_gap}


TRAIN_STEPS = 20
FALL_STEPS = 30
C1_STEPS = 100
# The first steps with the kernels against the same steps with the plain
# versions on the card: bf16 throughout, the two differ by K2's rounding
# flips (pooled kv within 1e-2), carried through the decoder and the loss;
# warmup makes the first update 0 and the next two tiny.
TRAIN_LOSS_RTOL = 1e-2


# The launch registry's keys (`ops._launch`): the main paths' kernels,
# their f32 twins (K4's cost is f32 in both dtypes: it has one count) and
# the split stages' row kernels; K4's variants count under "K4 <variant>".
MAIN_KEYS = ("K1", "K2", "K3", "K4", "K5 fwd", "K5 bwd")
F32_KEYS = ("K1 f32", "K2 f32", "K3 f32", "K5 fwd f32", "K5 bwd f32")
LN_KEYS = ("LN rows fwd", "LN rows fwd f32", "LN rows bwd",
           "LN rows bwd f32")
PAIR = ("pair MLP",)


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
    # K5's row-chunk keywords go unused: the plain version runs the
    # whole batch at once.
    chain_grad._backward_cuda = (
        lambda x, sp, fw, fb, zs, chunk_bytes=None, min_rows=None, **kw:
        chain_grad.chain_backward_plain(x, sp, fw, fb, zs, **kw))
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
    counts = launch_counts(MAIN_KEYS)
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
    counts = launch_counts(MAIN_KEYS)
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
    counts = launch_counts(MAIN_KEYS)
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
    k1 = launch_counts(MAIN_KEYS)["K1"]
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
# f32: the encoder-chain kernels computing in float32 (K1, K2, K3, K5)
# ---------------------------------------------------------------------------

# The f32 kernels against their plain f32 versions (TF32 off, so the plain
# products run in full f32).  The kernels multiply in 3xTF32 (each
# product f32-exact but lo(A) lo(B), ~2^-22) and the tensor cores round
# each partial sum toward zero, ~1.5e-5 relative over a 2048-term sum
# (the main loop moves its sums into f32 every 2048 terms); the plain
# versions sum in f32 (~1e-6):
# - every forward output: rtol 1e-4, atol 1e-4; the window argmax equal
#   wherever a window's top two values differ by more than the atol;
# - every gradient: rtol 1e-3 elementwise and atol 2e-4 of the tensor's
#   largest magnitude (the CPU test's f32 bound, tests/test_torch_chain_
#   grad.py, where gradients are of order 1; at full width a dW entry sums
#   20480 rows and reaches ~1e2, and the f32 rounding of such a sum alone,
#   ~6e-4 on either side, passes an absolute 2e-4 on entries near 0: an
#   H100 run read 1.5 times it on K3's dW3 with a relative L2
#   difference of 1.35e-6), with the plain backward run from the
#   kernel's own f32 z (K2's stash, which K5's recompute equals bit for
#   bit).  The ReLU gate is a step: where a LayerNorm output lies within
#   the two statistics' rounding of 0 (~1e-7), the two sides may open it
#   differently, which moves that stage's d gamma, d beta and d b in its
#   column by a whole cotangent, its dW column by one row's product, dx in
#   its row and every lower stage's dW a little, past any elementwise
#   bound at full width.  So the cotangent is 0 on every kv window (row,
#   without kv pooling) that holds a gate within F32_TIE of 0 on the plain
#   side: such a row's dz is 0 at every stage whichever way its gates
#   open, every other gate opens alike on both sides, and every element
#   of every gradient is held to the bound;
# - losses: step 1 rtol 1e-4, steps 2-3 rtol 1e-3.  The recipe's step 1
#   carries the kv tokens' f32 differences (up to ~6e-6) through four
#   decoder layers and the loss: an H100 run read 1.57e-5, past an rtol
#   of 1e-5.
F32_FWD_RTOL, F32_FWD_ATOL = 1e-4, 1e-4
F32_GRAD_RTOL, F32_GRAD_ATOL = 1e-3, 2e-4
F32_TIE = 1e-6
F32_LOSS_RTOL = (1e-4, 1e-3, 1e-3)
# K1's peak device memory at (3, 16384) in f32: the two widest f32
# activations (604 MB) and the kv tokens.
K1_F32_PEAK_BYTES = 0.70e9
F32_TRAIN_STEPS = 20            # (a) the parity model as shipped
F32_RECIPE_STEPS = 5            # (b) the recipe at f32
F32_BUDGET_S = 60.0
# The f32 shapes of part (c): (name, B, N, hidden, out, kv_pool, emit
# features).  The chain's (K2 / K3 and K5 in each flavour) ...
F32_CHAIN_SHAPES = (
    ("recipe", 8, 2560, FULL, 512, 4, False),
    ("parity features", 3, 2560, FULL, 512, 0, True),
    ("bench parity features", 128, 2560, FULL, 512, 0, True),
    ("ragged kv", 2, 200, (40, 72), 36, 4, True),
    ("ragged features", 2, 256, (40, 72), 36, 0, True),
    ("ragged slim", 2, 200, (40, 72), 36, 4, False),
    ("ragged cluster", 2, 328, (600, 1100), 300, 4, True))
# ... and K1's: (B, N, hidden, out, kv_pool, tile).  kv windows of 5 and
# 41 rows cross the 128-row tiles; (600, 1100) runs clusters of 3 and 5.
F32_K1_SHAPES = (
    (3, 2560, FULL, 512, 4, 512), (3, 16384, FULL, 512, 4, 512),
    (128, 2560, FULL, 512, 4, 512), (2, 200, (40, 72), 36, 4, 200),
    (2, 200, (40, 72), 36, 0, 200), (2, 200, (40, 72), 36, 5, 200),
    (2, 328, (600, 1100), 300, 41, 328))


# The largest |kernel - plain| of each f32 kernel at each shape of
# F32_CHAIN_SHAPES and F32_K1_SHAPES as the FFMA main loop (full f32 fmaf,
# the loop the 3xTF32 one replaced) read it on an NVIDIA H100 80GB HBM3 at
# 700 W, running this script's f32_chain and f32_k1 from the commit
# before the replacement: forward outputs and stash (K2, K5 forward, K1)
# or every gradient (K3, K5 backward).  The inputs are seeded, so the
# figures repeat run to run.  Printed beside the 3xTF32 loop's figure.
FFMA_MAX_ABS = {
    "K2 recipe": 5.96e-06,
    "K5 forward recipe": 5.96e-06,
    "K3 recipe": 0.00177,
    "K5 backward recipe": 0.00177,
    "K2 parity features": 3.338e-06,
    "K5 forward parity features": 3.338e-06,
    "K3 parity features": 0.0001259,
    "K5 backward parity features": 0.0001259,
    "K2 bench parity features": 4.053e-06,
    "K5 forward bench parity features": 4.053e-06,
    "K5 backward bench parity features": 0.005081,
    "K2 ragged kv": 1.192e-06,
    "K5 forward ragged kv": 1.192e-06,
    "K3 ragged kv": 1.526e-05,
    "K5 backward ragged kv": 1.526e-05,
    "K2 ragged features": 7.153e-07,
    "K5 forward ragged features": 7.153e-07,
    "K3 ragged features": 1.24e-05,
    "K5 backward ragged features": 1.24e-05,
    "K2 ragged slim": 1.431e-06,
    "K5 forward ragged slim": 1.431e-06,
    "K3 ragged slim": 5.722e-06,
    "K5 backward ragged slim": 5.722e-06,
    "K2 ragged cluster": 4.053e-06,
    "K5 forward ragged cluster": 4.053e-06,
    "K3 ragged cluster": 9.155e-05,
    "K5 backward ragged cluster": 9.155e-05,
    "K1 B=3 N=2560 kv_pool 4": 3.338e-06,
    "K1 B=3 N=16384 kv_pool 4": 5.722e-06,
    "K1 B=128 N=2560 kv_pool 4": 4.292e-06,
    "K1 B=2 N=200 kv_pool 4": 9.537e-07,
    "K1 B=2 N=200 kv_pool 0": 1.431e-06,
    "K1 B=2 N=200 kv_pool 5": 1.907e-06,
    "K1 B=2 N=328 kv_pool 41": 3.457e-06,
}


def ffma_figure(key):
    v = FFMA_MAX_ABS.get(key)
    return "not measured" if v is None else f"{v:.3e}"


def f32_yardstick(torch, dev, card, name, m, hidden):
    """The widest stage's bare product (m, K) x (K, W) at an f32 chain
    shape: the kernels' STORE GEMM in f32 (3xTF32) beside torch.matmul in
    f32 with TF32 off (the yardstick; the port never calls it), both held
    to the float64 product."""
    from wireframe_tpu_torch.ops import chain_grad as cg
    from wireframe_tpu_torch.ops._launch import check, row_buffer

    k = max(range(len(hidden)), key=lambda i: hidden[i])
    kk, w_out = (8, *hidden)[k], hidden[k]
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    h = row_buffer(m, kk, torch.float32, dev).normal_(generator=gen)
    w = row_buffer(kk, w_out, torch.float32, dev).normal_(generator=gen)
    c = torch.empty(m, w_out, device=dev)
    lib = cg._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def gemm():
        check(lib.k23_gemm_f32(0, h.data_ptr(), h.stride(0), w.data_ptr(),
                               w.stride(0), None, c.data_ptr(), w_out, m,
                               w_out, kk, 1, kk, stream), "f32 STORE GEMM")
        return c

    exact = h.double() @ w.double()
    scale = exact.abs().max().item()
    rel = {"3xTF32 GEMM": gemm(), "torch.matmul f32": torch.matmul(h, w)}
    rel = {k: (v.double() - exact).abs().max().item() / scale
           for k, v in rel.items()}
    del exact
    ms = cuda_ms(torch, gemm, 10)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(h, w), 10)
    flops = 2.0 * m * kk * w_out
    bound = flops / H100_3XTF32_FLOPS * 1e3
    print(f"f32 yardstick {name}: the widest stage's product M={m} K={kk} "
          f"N={w_out}: 3xTF32 STORE GEMM {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms * 100:.1f}% of the "
          f"3xTF32 bound), torch.matmul f32, TF32 off {lib_ms:.4f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s); largest error against "
          f"float64 / its largest magnitude: {rel['3xTF32 GEMM']:.2e} and "
          f"{rel['torch.matmul f32']:.2e} [{card}]", flush=True)
    if not rel["3xTF32 GEMM"] <= F32_FWD_RTOL:
        raise AssertionError(f"f32 yardstick {name}: the GEMM is off by "
                             f"{rel['3xTF32 GEMM']:.2e}")
    del h, w, c


def f32_plan_is_3xtf32(label, plan):
    if plan["main_loop"] != "3xtf32" or plan["split"] is None:
        raise AssertionError(f"{label}: the f32 plan runs "
                             f"{plan['main_loop']}, not the 3xTF32 loop")


def f32_params(torch, rng, dev, hidden, out):
    """recipe_encoder_params with full f32 weights."""
    return recipe_encoder_params(torch, rng, dev, hidden=hidden, out=out,
                                 weight_dtype=torch.float32)


def f32_forward_close(label, got, want, keys):
    """Each forward output against its plain f32 version; returns the
    largest absolute difference."""
    max_abs = 0.0
    for key in keys:
        g, w = got[key].float(), want[key].float()
        if g.shape != w.shape or not bool(g.isfinite().all()):
            raise AssertionError(f"{label} {key}: shape {tuple(g.shape)} "
                                 f"or non-finite")
        err = (g - w).abs()
        ok = bool((err <= F32_FWD_ATOL + F32_FWD_RTOL * w.abs()).all())
        max_abs = max(max_abs, err.max().item())
        print(f"{label} {key:14s} max_abs {err.max().item():.3e} (rtol "
              f"{F32_FWD_RTOL}, atol {F32_FWD_ATOL}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label} {key} disagrees")
    return max_abs


def f32_tied_rows(torch, x, stage_params, zs, p):
    """The rows (B * N,) of every kv window (p > 1) or row (p = 0) that
    holds a gate within F32_TIE of a tie: a stage's LayerNorm output,
    rebuilt from the f32 z as the plain backward rebuilds it, that close
    to 0; and the count of such gates."""
    from wireframe_tpu_torch.ops.chain_grad import _stage_stats

    b, n = x.shape[:2]
    rows = torch.zeros(b * n, dtype=torch.bool, device=x.device)
    count = 0
    for z, (_w, _b, g, be) in zip(zs, stage_params):
        _, xhat, _ = _stage_stats(z.reshape(b * n, -1).float(), g, be,
                                  torch.float32)
        near = (xhat * g.float() + be.float()).abs() <= F32_TIE
        rows |= near.any(1)
        count += int(near.sum())
        del xhat, near
    if p:
        rows = rows.reshape(b, n // p, p).any(-1, keepdim=True).expand(
            b, n // p, p).reshape(-1)
    return rows, count


def f32_grads_close(torch, label, gk, gp, tied):
    """dx and every parameter gradient of a backward against its plain
    version, every element (see F32_GRAD_RTOL); returns the largest
    absolute difference."""
    flat = lambda r: [("dx", r[0])] + [  # noqa: E731
        (f"{t}{i}", v) for i, st in enumerate(r[1])
        for t, v in zip(("dW", "db", "dgamma", "dbeta"), st)] + [
        ("dW_proj", r[2]), ("db_proj", r[3])]
    worst, worst_at, max_abs = 0.0, "", 0.0
    for (name, a), (_, w) in zip(flat(gk), flat(gp)):
        if a.shape != w.shape or not bool(a.isfinite().all()):
            raise AssertionError(f"{label} {name}: shape or non-finite")
        err = (a - w).abs()
        max_abs = max(max_abs, err.max().item())
        r = (err / (F32_GRAD_ATOL * w.abs().max()
                    + F32_GRAD_RTOL * w.abs())).max().item()
        if r > worst:
            worst, worst_at = r, name
    rows, gates = tied
    # The zeroed rows must leave the check its data.
    ok = worst <= 1.0 and rows.float().mean().item() <= 0.1
    print(f"{label}: dx and {len(flat(gk)) - 1} parameter gradients, "
          f"largest |diff| / (atol max|plain| + rtol |plain|) {worst:.3f} "
          f"({worst_at}; limit 1 at rtol {F32_GRAD_RTOL}, atol "
          f"{F32_GRAD_ATOL}), every element; cotangent 0 on the "
          f"{int(rows.sum())} of {rows.numel()} rows behind {gates} gates "
          f"within {F32_TIE} of a tie; max_abs {max_abs:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} disagrees")
    return max_abs


def f32_k1(torch, dev, card):
    """K1 in f32 against its plain f32 version at F32_K1_SHAPES; its point
    features and kv tokens array_equal to K5's f32 forward; two launches
    array_equal; times, bounds and the peak memory at (3, 16384).
    Returns ({(B, N): timing fields}, max abs error)."""
    from wireframe_tpu_torch.ops.chain_grad import remat_chain_forward
    from wireframe_tpu_torch.ops.fused_encoder import (
        fused_point_encoder,
        fused_point_encoder_plain,
        k1_plan,
    )

    rng = np.random.default_rng(12)
    f32 = torch.float32
    timing, max_abs = {}, 0.0
    for b, n, hidden, out, p, tile in F32_K1_SHAPES:
        f32_plan_is_3xtf32(f"K1 f32 B={b} N={n}",
                           k1_plan(b, n, 8, hidden, out, p, f32))
        stages, fw, fb = f32_params(torch, rng, dev, hidden, out)
        x = torch.tensor(padded_clouds(rng, b, n), device=dev)
        kw = dict(tile=tile, compute_dtype=f32, kv_pool=p)
        feats = b * n <= 3 * 2560
        got = fused_point_encoder(x, stages, fw, fb,
                                  return_point_features=feats, **kw)
        want = fused_point_encoder_plain(x, stages, fw, fb,
                                         return_point_features=feats, **kw)
        err = f32_forward_close(f"K1 f32 B={b} N={n} kv_pool {p}", got,
                                want, list(want))
        max_abs = max(max_abs, err)
        del want
        if b > 1:
            for key in ("masked_mean", "masked_max") + (
                    ("kv_features",) if p else ()):
                if got[key][-1].abs().max().item() != 0.0:
                    raise AssertionError(f"all-padding sample {key} != 0")
        if feats:
            k5 = remat_chain_forward(x, stages, fw, fb, kv_pool=p,
                                     emit_features=True, compute_dtype=f32)
            again = fused_point_encoder(x, stages, fw, fb,
                                        return_point_features=True, **kw)
            same = {"point_features": torch.equal(got["point_features"],
                                                  k5["features"])}
            if p:
                same["kv_features"] = torch.equal(got["kv_features"],
                                                  k5["pooled"])
            same["two launches"] = all(torch.equal(got[k], again[k])
                                       for k in got)
            print(f"K1 f32 B={b} N={n} kv_pool {p}: array_equal to K5's f32 "
                  f"forward and to a second launch {same}", flush=True)
            if not all(same.values()):
                raise AssertionError(f"K1 f32 B={b} N={n}: {same}")
            del k5, again
        del got
        call = lambda: fused_point_encoder(x, stages, fw, fb, **kw)  # noqa
        if (b, n) == (3, 16384):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del res
            print(f"K1 f32 B={b} N={n} peak device memory of one call: "
                  f"{peak / 1e9:.4f} GB beyond the {base / 1e9:.4f} GB "
                  f"allocated before it (limit {K1_F32_PEAK_BYTES / 1e9} GB;"
                  f" bf16 {K1_PEAK_BYTES / 1e9}) [{card}]", flush=True)
            if peak > K1_F32_PEAK_BYTES:
                raise AssertionError(f"K1 f32 holds {peak} bytes")
        ms = cuda_ms(torch, call, 10)
        plain_ms = cuda_ms(torch, lambda: fused_point_encoder_plain(
            x, stages, fw, fb, **kw), 3)
        bound, bound_by = k1_bound_ms(b, n, 8, hidden, out, p, f32=True)
        simt = 2.0 * b * n * sum(i * o for i, o in zip(
            (8, *hidden), (*hidden, out))) / H100_F32_FLOPS * 1e3
        if b * n >= 3 * 2560:
            timing[(b, n)] = {"shape": f"B={b} N={n} kv_pool={p}",
                              "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "bound_by": bound_by}
        key = f"K1 B={b} N={n} kv_pool {p}"
        print(f"K1 f32 time B={b} N={n} kv_pool {p}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"3xTF32), {bound / ms * 100:.1f}% of bound; FP32 SIMT "
              f"ceiling {simt:.3f} ms ({simt / ms * 100:.1f}%); largest "
              f"|kernel - plain| {err:.3e} (FFMA main loop: "
              f"{ffma_figure(key)}) [{card}]", flush=True)
        del x
    return timing, max_abs


def f32_chain(torch, dev, card):
    """K2 / K3 and K5 in f32 against their plain f32 versions at
    F32_CHAIN_SHAPES: forwards at the forward tolerance (stash, window
    argmax), backwards from the kernel's own stash; K5's forward
    array_equal to K2's; two launches array_equal; times and bounds.
    Returns {"K2", "K3", "K5 forward", "K5 backward": timing fields at
    the recipe's (8, 2560) and the parity (3, 2560) shapes}."""
    from wireframe_tpu_torch.ops.chain_grad import (
        chain_backward,
        chain_backward_plain,
        chain_forward,
        chain_forward_plain,
        remat_chain_backward,
        remat_chain_forward,
    )
    from wireframe_tpu_torch.ops.hopper_gemm import chain_plan

    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    f32 = torch.float32
    result, peaks, timing = {}, {}, {}
    for name, b, n, hidden, out, p, emit in F32_CHAIN_SHAPES:
        f32_plan_is_3xtf32(f"f32 chain {name}",
                           chain_plan(b * n, 8, hidden, out, f32))
        stages, fw, fb = f32_params(torch, rng, dev, hidden, out)
        x = torch.tensor(padded_clouds(rng, b, n), device=dev)
        kw = dict(kv_pool=p, compute_dtype=f32, emit_features=emit)
        got = chain_forward(x, stages, fw, fb, **kw)
        k5 = remat_chain_forward(x, stages, fw, fb, **kw)
        want = chain_forward_plain(x, stages, fw, fb,
                                   **{**kw, "emit_features": True})
        keys = (["pooled", "sums"] if p else []) + (["features"] if emit
                                                     else [])
        fwd_abs = f32_forward_close(f"K2 f32 {name} ({b}, {n})", got, want,
                                    keys)
        fwd_abs = max(fwd_abs, f32_forward_close(
            f"K2 f32 {name} ({b}, {n}) stash", {
                f"z{k}": z for k, z in enumerate(got["zs"])}, {
                f"z{k}": z for k, z in enumerate(want["zs"])},
            [f"z{k}" for k in range(len(hidden))]))
        same = [k for k in k5 if not torch.equal(k5[k], got[k])]
        if same or "zs" in k5 or any(z.dtype != f32 for z in got["zs"]):
            raise AssertionError(f"K5 f32 forward differs from K2's in "
                                 f"{same} ({name})")
        if p:
            f = want["features"]
            valid = x.sum(-1).abs() > 1e-9
            filled = torch.where(valid[..., None], f,
                                 torch.full_like(f, -torch.inf))
            top2 = torch.topk(filled.reshape(b, n // p, p, -1), 2,
                              dim=2).values
            clear = ~(top2[:, :, 0] - top2[:, :, 1] <= F32_FWD_ATOL)
            agree = got["idx"] == want["idx"]
            print(f"K2 f32 {name} idx: agreement "
                  f"{agree.float().mean().item() * 100:.4f}% overall, "
                  f"{agree[clear].float().mean().item() * 100:.4f}% where "
                  f"the top-two gap exceeds {F32_FWD_ATOL}", flush=True)
            if not bool(agree[clear].all()):
                raise AssertionError(f"K2 f32 idx disagrees ({name})")
            del f, filled, top2
        del want
        # Cotangents, 0 on the windows / rows behind a near-tie gate.
        zs = got["zs"]
        tied = f32_tied_rows(torch, x, stages, zs, p)
        keep = (~tied[0]).float().reshape(b, n, 1)
        cot = {}
        if p:
            wkeep = keep.reshape(b, n // p, p, 1)[:, :, 0]
            cot = dict(dpool=torch.randn(got["pooled"].shape, device=dev,
                                         generator=gen) * wkeep,
                       dsums=torch.randn(got["sums"].shape, device=dev,
                                         generator=gen) * 0.1 * wkeep,
                       idx=got["idx"])
        if emit:
            cot["g"] = torch.randn((b, n, out), device=dev,
                                   generator=gen) * 0.1 * keep
        bkw = dict(kv_pool=p, compute_dtype=f32, **cot)
        gp = chain_backward_plain(x, stages, fw, fb, zs, **bkw)
        small = b * n <= 8 * 2560
        bwd_abs = {}
        for label, fn in (
                ("K3", lambda: chain_backward(x, stages, fw, fb, zs, **bkw)),
                ("K5 backward", lambda: remat_chain_backward(
                    x, stages, fw, fb, **bkw))):
            if label == "K3" and not small:
                continue
            gk = fn()
            bwd_abs[label] = f32_grads_close(
                torch, f"{label} f32 {name} ({b}, {n})", gk, gp, tied)
            if not small:
                continue
            again = fn()
            same = [torch.equal(u, v) for u, v in zip(
                [gk[0], *[t for st in gk[1] for t in st], gk[2], gk[3]],
                [again[0], *[t for st in again[1] for t in st], again[2],
                 again[3]])]
            if not all(same):
                raise AssertionError(f"{label} f32 {name}: two launches "
                                     "differ")
            del gk, again
        peaks.update(f32_k5_chunks(torch, card, name, b, n, hidden, out,
                                   lambda **kw: remat_chain_backward(
                                       x, stages, fw, fb, **bkw, **kw),
                                   gp, tied, timing))
        del gp
        if small:
            yard = grad_errors(
                remat_chain_backward(x, stages, fw, fb, **bkw),
                chain_backward_plain(x, stages, fw, fb, None, **bkw))
            print(f"K5 f32 {name} ({b}, {n}) yardstick, against the plain "
                  f"version recomputing its own z: worst max rel err "
                  f"{yard[0]:.2e} ({yard[1]}), worst mean rel err "
                  f"{yard[2]:.2e} ({yard[3]}); the backwards repeat bit "
                  f"for bit", flush=True)
        # Every shape timed: K2 / K3 where the shape has kv windows (the
        # stash flavour; K3 up to (8, 2560)), K5 always.
        timed = []
        if p:
            timed.append(("K2", lambda: chain_forward(x, stages, fw, fb,
                                                      **kw),
                          lambda: chain_forward_plain(x, stages, fw, fb,
                                                      **kw), False, fwd_abs))
        if "K3" in bwd_abs and p:
            timed.append(("K3", lambda: chain_backward(x, stages, fw, fb, zs,
                                                       **bkw),
                          lambda: chain_backward_plain(x, stages, fw, fb, zs,
                                                       **bkw), True,
                          bwd_abs["K3"]))
        timed += [("K5 forward", lambda: remat_chain_forward(
            x, stages, fw, fb, **kw), lambda: chain_forward_plain(
                x, stages, fw, fb, stash=False, **kw), False, fwd_abs),
                  ("K5 backward", lambda: remat_chain_backward(
                      x, stages, fw, fb, **bkw),
                   lambda: chain_backward_plain(x, stages, fw, fb, None,
                                                **bkw), True,
                   bwd_abs["K5 backward"])]
        for label, fn, plain, backward, err in timed:
            ms = cuda_ms(torch, fn, 10)
            plain_ms = cuda_ms(torch, plain, 3)
            if label.startswith("K5"):
                bound, bound_by = k5_bound_ms(b, n, 8, hidden, out, p,
                                              emit, backward, f32=True)
            else:
                bound, bound_by = chain_bound_ms(b, n, 8, hidden, out,
                                                 p, backward, f32=True)
            macs = sum(i * o for i, o in zip((8, *hidden),
                                             (*hidden, out)))
            ops = 2.0 * b * n * macs * (
                (3 if label.startswith("K5") else 2) if backward else 1)
            simt = ops / H100_F32_FLOPS * 1e3
            print(f"{label} f32 time {name} ({b}, {n}): kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound:.4f} ms ({bound_by}, 3xTF32), "
                  f"{bound / ms * 100:.1f}% of bound; FP32 SIMT ceiling "
                  f"{simt:.3f} ms ({simt / ms * 100:.1f}%); largest "
                  f"|kernel - plain| {err:.3e} (FFMA main loop: "
                  f"{ffma_figure(f'{label} {name}')}); library: none "
                  f"[{card}]", flush=True)
            if (name, label) in (("recipe", "K2"), ("recipe", "K3"),
                                 ("parity features", "K5 forward"),
                                 ("parity features", "K5 backward")):
                result[label] = {
                    "shape": f"B={b} N={n} kv_pool={p}"
                    + ("" if emit else " slim"), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "max_abs_err": err}
        # Where the time goes: the K3 / K5 backward by kernel.
        for label, fn, *_ in timed:
            if name in ("recipe", "parity features") and label in (
                    "K3", "K5 backward"):
                chain_breakdown(torch, card, f"{label} f32 {name} ({b}, "
                                f"{n})", fn)
        del x, got, k5, zs, cot, tied, keep, timed
        f32_yardstick(torch, dev, card, name, b * n, hidden)
    result["K5 backward"]["peak"] = peaks
    result["K5 backward"]["bench"] = timing
    return result


def f32_k5_chunks(torch, card, name, b, n, hidden, out, call, gp, tied,
                  timing):
    """K5 f32's row chunks at one F32_CHAIN_SHAPES shape: one chunk up to
    (8, 2560); where there are more, the call against itself in one chunk
    (dx, d b, d gamma, d beta array_equal, dW at the f32 gradient bound)
    and both timed; at "ragged kv" the call forced into chunks of one row
    tile, against the plain version and the one-chunk call; at (3, 2560)
    and (128, 2560) the peak device memory (`k5_bwd_peak`).  Returns the
    peak figures."""
    from wireframe_tpu_torch.ops.chain_grad import remat_plan

    f32 = torch.float32
    plan = remat_plan(b * n, 8, hidden, out, f32)
    label = f"K5 backward f32 {name} ({b}, {n})"
    print(f"{label}: {len(plan['chunks'])} chunk(s) of {plan['chunk_rows']} "
          f"rows", flush=True)
    if b * n <= 8 * 2560 and len(plan["chunks"]) != 1:
        raise AssertionError(f"{label}: more than one chunk")
    gk = call()
    if len(plan["chunks"]) > 1:
        one = call(**ONE_CHUNK)
        k5_chunks_equal(torch, label, gk, one, lambda a, w: f32_grads_close(
            torch, f"{label} {len(plan['chunks'])} chunks vs one", a, w,
            tied))
        del one
        ms = cuda_ms(torch, call, 10)
        one_ms = cuda_ms(torch, lambda: call(**ONE_CHUNK), 10)
        print(f"{label} time, same call: {len(plan['chunks'])} chunks "
              f"{ms:.3f} ms, one chunk {one_ms:.3f} ms [{card}]", flush=True)
        timing.update({"shape": f"B={b} N={n}", "ms": ms,
                       "one_chunk_ms": one_ms})
    if name == "ragged kv":
        forced = remat_plan(b * n, 8, hidden, out, f32, **FORCED_CHUNKS)
        flabel = (f"{label} forced into {len(forced['chunks'])} chunks "
                  f"{forced['chunks']}")
        gf = call(**FORCED_CHUNKS)
        f32_grads_close(torch, f"{flabel} vs plain", gf, gp, tied)
        k5_chunks_equal(torch, flabel, gf, call(**ONE_CHUNK),
                        lambda a, w: f32_grads_close(
                            torch, f"{flabel} vs one", a, w, tied))
        del gf
    del gk
    peaks = {}
    if (b, n) in ((3, 2560), (128, 2560)):
        peaks[f"B={b} N={n}"] = k5_bwd_peak(torch, label, ("f32", b, n),
                                            plan, call, card)
        if len(plan["chunks"]) > 1:
            peaks[f"B={b} N={n} one chunk"] = k5_bwd_peak(
                torch, f"{label} in one chunk", ("one chunk", b, n),
                remat_plan(b * n, 8, hidden, out, f32, **ONE_CHUNK),
                lambda: call(**ONE_CHUNK), card)
    return peaks


def _f32_losses(torch, config, sets, batch, dev, plain):
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.train.loop import train_model

    w = _Losses()
    with plain_kernels() if plain else contextlib.nullcontext():
        train_model(load_config(config, sets), [batch], metric_writer=w,
                    device=dev)
    return [r["total_loss"] for r in w.rows]


def _f32_compare(label, kern, plain):
    rel = [abs(a - b) / abs(b) for a, b in zip(kern, plain)]
    ok = len(rel) == 3 and all(r <= t for r, t in zip(rel, F32_LOSS_RTOL))
    print(f"f32 {label}: first 3 losses, kernels {kern} vs plain versions "
          f"{plain}: relative differences {rel} (limits {F32_LOSS_RTOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"f32 {label} losses differ from the plain run")


def f32_phase(torch, dev, card, work):
    """(a) the parity model as shipped (configs/default.yaml +
    model.use_pallas_encoder=true: f32), trained 20 steps through K5 f32
    and K4 and served over the four buckets through K1 f32; (b) the recipe
    at f32 (stash), 5 steps through K2 f32, K3 f32 and K4; each first 3
    losses against the plain versions; (c) the kernels alone.  Returns
    {key: fields} for the kernels line."""
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.bucketing import choose_bucket
    from wireframe_tpu_torch.io.obj import load_wireframe
    from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
    from wireframe_tpu_torch.serve import WireframePredictor
    from wireframe_tpu_torch.train.checkpoint import save_checkpoint
    from wireframe_tpu_torch.train.loop import (
        epoch_seed,
        init_model,
        train_model,
    )
    from wireframe_tpu_torch.utils.synth import (
        make_box_building_batch,
        targets_near_slots,
    )

    t0 = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("the plain f32 versions would run in TF32")
    none = dict.fromkeys(MAIN_KEYS + F32_KEYS, 0)
    out = {}

    def counted(want):
        counts = launch_counts(MAIN_KEYS + F32_KEYS)
        if counts != {**none, **want}:
            raise AssertionError(f"launches {counts}, expected "
                                 f"{ {**none, **want} }")
        return counts

    # (a) The parity model as shipped, trained: counts to 0, 20 steps,
    # counts read.
    shipped = ["model.use_pallas_encoder=true", "train.log_every=1"]
    cfg = load_config(PARITY,
                      shipped + [f"train.num_epochs={F32_TRAIN_STEPS}"])
    m = cfg.model
    print(f"f32 (a) parity model as shipped: {m.compute_dtype}, fused "
          f"encoder {m.use_pallas_encoder}, chain_backward "
          f"{m.chain_backward}, batch {cfg.train.batch_size} x "
          f"{cfg.data.num_points}, lr {cfg.train.learning_rate}", flush=True)
    if m.compute_dtype != "float32":
        raise AssertionError("configs/default.yaml no longer ships f32")
    batch = make_box_building_batch(cfg, cfg.train.batch_size, seed=0)
    writer = _Losses()
    reset_launches()
    t1 = time.perf_counter()
    state = train_model(cfg, [batch], metric_writer=writer, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    losses = [r["total_loss"] for r in writer.rows]
    out["train"] = counted({"K4": F32_TRAIN_STEPS,
                            "K5 fwd f32": F32_TRAIN_STEPS,
                            "K5 bwd f32": F32_TRAIN_STEPS})
    print(f"f32 (a) {F32_TRAIN_STEPS} steps in {secs:.2f} s "
          f"({secs / F32_TRAIN_STEPS * 1e3:.1f} ms a step, metrics read "
          f"every step); launches {out['train']}; losses "
          f"{', '.join(f'{v:.5f}' for v in losses)} [{card}]", flush=True)
    if len(losses) != F32_TRAIN_STEPS or not all(map(math.isfinite,
                                                     losses)):
        raise AssertionError("an f32 parity loss is not finite")
    # The fall at lr 1e-4 (at its lr 1e-3 the loss first overshoots; see
    # parity_phase), from the same start.
    fall = _f32_losses(torch, PARITY, shipped + [
        "train.learning_rate=0.0001", f"train.num_epochs={F32_TRAIN_STEPS}"],
        batch, dev, plain=False)
    first, last = float(np.mean(fall[:3])), float(np.mean(fall[-3:]))
    print(f"f32 (a) {F32_TRAIN_STEPS} steps at lr 1e-4: mean loss of the "
          f"first 3 steps {first:.5f}, of the last 3 {last:.5f}", flush=True)
    if not all(map(math.isfinite, fall)) or not last < first:
        raise AssertionError("the f32 parity loss does not fall")
    # The first 3 steps at the shipped lr, kernels against the plain
    # versions, dropout off, the targets next to predicted slots.
    cmp_sets = shipped + ["model.attn_dropout=0", "model.edge_dropout=0",
                          "train.num_epochs=3"]
    ccfg = load_config(PARITY, cmp_sets)
    near = targets_near_slots(ccfg, init_model(ccfg, dev), batch,
                              epoch_seed(ccfg.train.seed, 0), device=dev)
    _f32_compare("(a) parity", *(
        _f32_losses(torch, PARITY, cmp_sets, near, dev, plain)
        for plain in (False, True)))

    # (a) Served: the trained checkpoint over the four buckets, counts to
    # 0 just before, read just after.
    path = save_checkpoint(os.path.join(work, "f32_ckpt"), state, cfg,
                           epoch=F32_TRAIN_STEPS)
    predictor = WireframePredictor(path, device=dev)
    sizes = (1300, 3000, 6000, 12000, 20000)
    rng = np.random.default_rng(14)
    offset = np.array([534000.0, 6588000.0, 40.0])
    paths = []
    for i, n in enumerate(sizes):
        pth = os.path.join(work, f"f32_cloud{i}_{n}.xyz")
        np.savetxt(pth, synthetic_building(rng, n, offset), fmt="%.4f")
        paths.append(pth)
    buckets = [choose_bucket(n, predictor.buckets) for n in sizes]
    if sorted(set(buckets)) != sorted(predictor.buckets):
        raise AssertionError(f"f32 clouds miss a bucket: {buckets}")
    batches = sum(-(-buckets.count(k) // predictor.batch_size)
                  for k in set(buckets))
    reset_launches()
    results = predictor.predict_files(paths, out_dir=os.path.join(
        work, "f32_obj"))
    torch.cuda.synchronize()
    out["serve"] = counted({"K1 f32": batches})
    for pth, r in zip(paths, results):
        v, e = r["vertices"], r["edges"]
        lv, le = load_wireframe(r["obj_path"])
        if not np.isfinite(v).all() or lv.shape != v.shape or (
                len(le) != r["num_edges"]):
            raise AssertionError(f"f32 checkpoint: {pth} does not serve")
    print(f"f32 (a) served {len(paths)} clouds in {batches} batches over "
          f"buckets {predictor.buckets}; launches {out['serve']}; .obj files "
          f"load back", flush=True)
    pcs = [predictor._preprocess(np.loadtxt(pth))["pc"] for pth in paths[:2]]
    xb = torch.tensor(predictor.batch_array(pcs, predictor.buckets[1]),
                      device=dev)
    plain_model = PointCloudToWireframe(load_config(PARITY, [
        "model.use_pallas_encoder=false"]).model).to(dev).eval()
    plain_model.load_state_dict(predictor.model.state_dict(), strict=True)
    with torch.inference_mode():
        f32_forward_close("f32 (a) served batch, K1 f32 vs the plain f32 "
                          "encoder:", predictor.model(xb), plain_model(xb),
                          list(MODEL_ATOL))
    del predictor, plain_model, state

    # (b) The recipe at f32 with the stash chain: counts to 0, 5 steps,
    # counts read; the first 3 against the plain versions.
    rsets = ["model.compute_dtype=float32", "train.overfit_one_batch=true",
             "train.log_every=1", "model.attn_dropout=0",
             "model.edge_dropout=0"]
    rcfg = load_config(RECIPE,
                       rsets + [f"train.num_epochs={F32_RECIPE_STEPS}"])
    if rcfg.model.chain_backward != "stash":
        raise AssertionError("the recipe no longer ships the stash chain")
    rbatch = targets_near_slots(
        rcfg, init_model(rcfg, dev),
        make_box_building_batch(rcfg, rcfg.train.batch_size, seed=0),
        epoch_seed(rcfg.train.seed, 0), device=dev)
    reset_launches()
    t1 = time.perf_counter()
    w = _Losses()
    train_model(rcfg, [rbatch], metric_writer=w, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    rl = [r["total_loss"] for r in w.rows]
    out["recipe"] = counted({"K2 f32": F32_RECIPE_STEPS,
                             "K3 f32": F32_RECIPE_STEPS,
                             "K4": F32_RECIPE_STEPS})
    print(f"f32 (b) recipe, float32, stash, {rcfg.train.batch_size} x "
          f"{rcfg.data.num_points}: {F32_RECIPE_STEPS} steps in {secs:.2f} s;"
          f" launches {out['recipe']}; losses {rl} [{card}]", flush=True)
    if not all(map(math.isfinite, rl)):
        raise AssertionError("an f32 recipe loss is not finite")
    _f32_compare("(b) recipe", rl[:3], _f32_losses(
        torch, RECIPE, rsets + ["train.num_epochs=3"], rbatch, dev,
        plain=True))

    # (c) The kernels alone.
    out["K1"] = f32_k1(torch, dev, card)
    out["chain"] = f32_chain(torch, dev, card)
    secs = time.perf_counter() - t0
    print(f"f32 phase: {secs:.1f} s (budget {F32_BUDGET_S:.0f} s) [{card}]",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Limits: every shape the JAX kernels take
# ---------------------------------------------------------------------------

LIMITS_BUDGET_S = 60.0
LIMITS_STEPS = 5                 # (a), (b): steps of the main path
LIMITS_F32_STEPS = 3             # (c)
# (c)'s losses against the plain versions: step 1 (the forward alone) at
# the f32 phase's 1e-4; steps 2-3 at the training phase's bound.  The
# shipped lr is 1e-3 and Adam's first update moves every weight by
# +-lr, so a gradient within f32 summation noise of 0 (or behind a ReLU
# gate within rounding of a tie) moves its weight 2 lr apart on the two
# sides; with the 4096 stage's 8.4M weights a first run read 2.0e-5 at
# step 2 and 1.4e-3 at step 3.  The gradients themselves are held
# element by element in limits_chain.
LIMITS_F32_RTOL = (1e-4, TRAIN_LOSS_RTOL, TRAIN_LOSS_RTOL)
LIMITS_F32_CHUNKS = 2            # (c)'s K5 backward: row chunks
WIDE = (512, 1024, 4096, 1024)   # the recipe with a 4096-wide stage
WIDE_SET = "model.encoder_hidden_dims=512,1024,4096,1024"
# One cloud per bucket (2048, 4096, 8192, 16384).
LIMITS_SIZES = (1300, 3000, 6000, 12000)
# K4 past the shapes it once took: (B, R, C, highest count drawn).  At
# (8, 256, 256) the costs leave shared memory; (4, 300, 512) is the warp
# variant's widest row; (2, 64, 1024) runs the block variant; (1, 32,
# 16384) the block variant with its state in device memory.
LIMITS_K4 = ((8, 256, 256, 255), (4, 300, 512, 64), (2, 64, 1024, 64),
             (1, 32, 16384, 32))
# The chain kernels alone: (name, B, N, hidden, out, kv_pool, K1's tile).
LIMITS_CHAIN = (("recipe with a 4096 stage", 8, 2560, WIDE, 512, 4, 512),
                ("ragged wide", 2, 328, (2304, 8192), 2304, 4, 328))


def _limits_paths(work):
    rng = np.random.default_rng(15)
    offset = np.array([534000.0, 6588000.0, 40.0])
    paths = []
    for i, n in enumerate(LIMITS_SIZES):
        p = os.path.join(work, f"limitscloud{i}_{n}.xyz")
        np.savetxt(p, synthetic_building(rng, n, offset), fmt="%.4f")
        paths.append(p)
    return paths


def _limits_counted(label, want):
    """The main path's counts, K1 - K5 (bf16 and f32), the row kernels and
    K4's variants, against `want` (every other count 0)."""
    counts = launch_counts(MAIN_KEYS + F32_KEYS + LN_KEYS)
    counts.update((k, v) for k, v in launch_counts().items()
                  if k.startswith("K4 "))
    expected = {**{k: 0 for k in counts}, **want}
    print(f"limits {label}: launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != expected:
        raise AssertionError(f"limits {label}: launches {counts}, expected "
                             f"{expected}")
    return counts


def _limits_recipe(torch, dev, card, work, tag, extra, paths, want_train):
    """Serve one batch per bucket, then train LIMITS_STEPS steps at 8 x
    2560, the first 3 losses against the plain versions.  Returns the
    served and the trained launch counts."""
    from wireframe_tpu_torch.bridge import init_flax_params
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.utils.synth import make_box_building_batch

    base = ["train.overfit_one_batch=true", "train.log_every=1"]
    cfg = load_config(RECIPE, base + extra
                      + [f"train.num_epochs={LIMITS_STEPS}"])
    m = cfg.model
    print(f"limits {tag}: recipe + {extra}: encoder "
          f"{m.encoder_hidden_dims}->{m.encoder_output_dim}, max_vertices "
          f"{m.max_vertices}, {m.compute_dtype}, chain_backward "
          f"{m.chain_backward}", flush=True)
    flat = init_flax_params(m, SERVE_SEED)
    _, k1, batches = _serve_layout(dev, card, work, f"limits {tag}", flat,
                                   cfg, extra, paths)
    served = _limits_counted(f"{tag} served", {
        "K1": batches, **({"LN rows fwd": batches}
                          if "LN rows fwd" in want_train else {})})
    batch = make_box_building_batch(cfg, cfg.train.batch_size, seed=0)
    t0 = time.perf_counter()
    losses, _, _ = _train_layout(torch, dev, cfg, batch, flat)
    secs = time.perf_counter() - t0
    trained = _limits_counted(f"{tag} trained", want_train)
    plain_cfg = load_config(RECIPE, base + extra + ["train.num_epochs=3"])
    plain, _, _ = _train_layout(torch, dev, plain_cfg, batch, flat,
                                plain=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    print(f"limits {tag}: {LIMITS_STEPS} steps at {cfg.train.batch_size} x "
          f"{cfg.data.num_points} in {secs:.2f} s, losses {losses}; first "
          f"3 against the plain versions {plain}: max rel diff "
          f"{max(rel):.2e} (rtol {TRAIN_LOSS_RTOL}) [{card}]", flush=True)
    if not all(map(math.isfinite, losses)) or max(rel) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"limits {tag}: losses differ from the plain "
                             "run")
    return served, trained


def _limits_parity_f32(torch, dev, card):
    """(c) The parity model as shipped (f32) with a 4096-wide stage, 3
    steps at 3 x 2560 through K5 f32 (split; its backward in
    LIMITS_F32_CHUNKS row chunks) and K4, against the plain versions
    (dropout off, targets next to predicted slots)."""
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.ops import chain_grad
    from wireframe_tpu_torch.ops.chain_grad import remat_plan
    from wireframe_tpu_torch.ops.hopper_gemm import chain_plan
    from wireframe_tpu_torch.train.loop import epoch_seed, init_model
    from wireframe_tpu_torch.utils.synth import (
        make_box_building_batch,
        targets_near_slots,
    )

    sets = ["model.use_pallas_encoder=true", WIDE_SET, "train.log_every=1",
            "model.attn_dropout=0", "model.edge_dropout=0",
            f"train.num_epochs={LIMITS_F32_STEPS}"]
    cfg = load_config(PARITY, sets)
    m = cfg.model
    print(f"limits (c): parity model as shipped + {WIDE_SET}: "
          f"{m.compute_dtype}, chain_backward {m.chain_backward}, matcher "
          f"{cfg.train.matcher}, max_vertices {m.max_vertices}, batch "
          f"{cfg.train.batch_size} x {cfg.data.num_points}", flush=True)
    if m.compute_dtype != "float32" or m.chain_backward != "remat":
        raise AssertionError("configs/default.yaml no longer ships f32 remat")
    rows = cfg.train.batch_size * cfg.data.num_points
    dims = (rows, m.input_dim, tuple(m.encoder_hidden_dims),
            m.encoder_output_dim, torch.float32)
    f32_plan_is_3xtf32("limits (c)", chain_plan(*dims))
    # K5's backward in LIMITS_F32_CHUNKS row chunks: the split stage's row
    # kernels run on row ranges.
    chunking = {"chunk_bytes": 1, "min_rows": -(-rows // LIMITS_F32_CHUNKS)}
    chunks = remat_plan(*dims, **chunking)["chunks"]
    print(f"limits (c): K5 backward in {len(chunks)} chunks {chunks}",
          flush=True)
    if len(chunks) < 2:
        raise AssertionError("limits (c): K5 backward in one chunk")
    batch = targets_near_slots(
        cfg, init_model(cfg, dev),
        make_box_building_batch(cfg, cfg.train.batch_size, seed=0),
        epoch_seed(cfg.train.seed, 0), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    saved = chain_grad.REMAT_CHUNK_BYTES, chain_grad.REMAT_MIN_ROWS
    chain_grad.REMAT_CHUNK_BYTES = chunking["chunk_bytes"]
    chain_grad.REMAT_MIN_ROWS = chunking["min_rows"]
    try:
        kern = _f32_losses(torch, PARITY, sets, batch, dev, plain=False)
    finally:
        chain_grad.REMAT_CHUNK_BYTES, chain_grad.REMAT_MIN_ROWS = saved
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n, c = LIMITS_F32_STEPS, len(chunks)
    # The split stage's row kernels: forward once a step and once a
    # chunk in the recompute, backward once a chunk.
    counts = _limits_counted("(c) trained", {
        "K4": n, "K5 fwd f32": n, "K5 bwd f32": n,
        "LN rows fwd f32": n * (1 + c), "LN rows bwd f32": n * c,
        "K4 warp, costs in shared memory": n})
    plain = _f32_losses(torch, PARITY, sets, batch, dev, plain=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(kern, plain)]
    ok = len(rel) == n and all(r <= t for r, t in zip(rel, LIMITS_F32_RTOL))
    print(f"limits (c): {n} steps in {secs:.2f} s; losses, kernels {kern} "
          f"vs plain versions {plain}: relative differences {rel} (limits "
          f"{LIMITS_F32_RTOL}) {'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        raise AssertionError("limits (c): losses differ from the plain run")
    return counts


def limits_k4(torch, dev, card):
    """K4 at LIMITS_K4 against its plain version (array_equal) and scipy
    (where finite): random costs, forced ties, -0.0 among exact zeros, an
    unclamped NaN row, counts 0 and R; ns per scan step from steps_out.
    Returns [{timing fields}] per shape."""
    from scipy.optimize import linear_sum_assignment

    from wireframe_tpu_torch.ops.lockstep_lsa import (
        k4_plan,
        solve_lsa_rows,
        solve_lsa_rows_lockstep_plain,
    )

    rng = np.random.default_rng(16)
    timing = []
    for b, r, c, top in LIMITS_K4:
        shape = f"({b}, {r}, {c})"
        counts = rng.integers(min(4, top), top + 1, size=b).astype(np.int32)
        cases = [("random", (rng.random((b, r, c)) * 10).astype(np.float32),
                  counts, True)]
        if c <= 1024:
            cases.append(("ties", (rng.integers(0, 4, (b, r, c)) * 0.5)
                          .astype(np.float32), counts, True))
        if (b, r, c) == (8, 256, 256):
            zeros = (rng.integers(0, 3, (b, r, c)) * 0.5).astype(np.float32)
            zeros[(zeros == 0) & (rng.random(zeros.shape) < 0.5)] = -0.0
            cases.append(("-0.0 entries", zeros, counts, True))
        if (b, r, c) in ((4, 300, 512), (2, 64, 1024)):
            nan = (rng.random((b, r, c)) * 10).astype(np.float32)
            nan[np.arange(b), rng.integers(0, top, size=b)] = np.nan
            cases.append(("NaN row", nan, counts, False))
            edge = np.array([0, top] * (b // 2), np.int32)
            cases.append(("counts 0 and R", (rng.random((b, r, c)) * 10)
                          .astype(np.float32), edge, True))
        plan = k4_plan(r, c)
        for kind, cost, cnt, finite in cases:
            ct = torch.tensor(cost, device=dev)
            nt = torch.tensor(cnt, device=dev)
            got = solve_lsa_rows(ct, nt)
            want = solve_lsa_rows_lockstep_plain(ct, nt)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            g = got.cpu().numpy()
            worst = 0.0
            for i, k in enumerate(cnt if finite else ()):
                if k == 0:
                    continue
                rows, cols = linear_sum_assignment(cost[i, :k])
                best = cost[i, rows, cols].sum()
                have = cost[i, np.arange(k), g[i, :k]].sum()
                if len(set(g[i, :k].tolist())) != k or (
                        g[i, k:] != -1).any():
                    raise AssertionError(f"K4 {kind} {shape}: sample {i} "
                                         "not an assignment")
                worst = max(worst, abs(have - best) / max(abs(best), 1e-12))
            gap = f"{worst:.2e} (limit 1e-5)" if finite else "not checked"
            print(f"K4 {kind} {shape} [{plan['name']}]: array_equal to plain "
                  f"{equal}; worst relative cost gap to scipy {gap}",
                  flush=True)
            if not equal or worst > 1e-5:
                raise AssertionError(f"K4 {kind} {shape} disagrees")
        cost, cnt = cases[0][1], cases[0][2]
        ct = torch.tensor(cost, device=dev)
        nt = torch.tensor(cnt, device=dev)
        steps = torch.zeros(b, dtype=torch.int32, device=dev)
        solve_lsa_rows(ct, nt, steps_out=steps)
        ms = cuda_ms(torch, lambda: solve_lsa_rows(ct, nt), 10)
        plain_ms = cuda_ms(torch, lambda: solve_lsa_rows_lockstep_plain(
            ct, nt), 1)
        total, longest = int(steps.sum()), int(steps.max())
        t_ops = total * c * 9 / H100_F32_FLOPS * 1e3
        t_bytes = (cost.nbytes + cnt.nbytes + b * r * 4) / (
            H100_BYTES_PER_S) * 1e3
        bound = max(t_ops, t_bytes)
        ns = ms * 1e6 / longest
        print(f"K4 time {shape} [{plan['name']}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, {total} scan steps (longest sample "
              f"{longest}): {ns:.1f} ns per scan step of the longest sample;"
              f" bound {bound:.2e} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
              f"{bound / ms * 100:.3f}% of bound [{card}]", flush=True)
        timing.append({"shape": f"B={b} R={r} C={c}",
                       "variant": plan["name"], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": ("operations" if t_ops >= t_bytes
                                    else "bytes"),
                       "ns_per_scan_step": ns})
    return timing


def _limits_fwd(torch, label, dtype, got, want):
    keys = ["pooled", "sums", "features"]
    if dtype == torch.float32:
        err = f32_forward_close(label, got, want, keys)
        return max(err, f32_forward_close(
            f"{label} stash", {f"z{k}": z for k, z in enumerate(got["zs"])},
            {f"z{k}": z for k, z in enumerate(want["zs"])},
            [f"z{k}" for k in range(len(got["zs"]))]))
    err = forward_close(label, got, want, keys)
    for k, (g, w) in enumerate(zip(got["zs"], want["zs"])):
        g, w = g.float(), w.float()
        ulp = bf16_ulp(torch, w.abs().amax(-1, keepdim=True))
        off = ~((g - w).abs() <= ulp)
        print(f"{label} z{k} (width {w.shape[-1]}): {int(off.sum())} of "
              f"{off.numel()} elements more than one ulp of the row's max "
              "from the plain stash", flush=True)
        if off.any():
            for idx in off.nonzero()[:4].tolist():
                print(f"  at {idx}: kernel {g[tuple(idx)].item()}, plain "
                      f"{w[tuple(idx)].item()}, the row's ulp "
                      f"{ulp[tuple(idx[:-1])].item()}", flush=True)
            raise AssertionError(f"{label} stash z{k} off by more than one "
                                 "ulp")
    return err


def _limits_bwd(torch, label, dtype, gk, gp, remat, tied):
    if dtype == torch.float32:
        return f32_grads_close(torch, label, gk, gp, tied)
    worst_max, max_at, worst_mean, mean_at, err = grad_errors(gk, gp)
    lim = (K5_MAX_REL, K5_MEAN_REL) if remat else (K3_MAX_REL, K3_MEAN_REL)
    ok = worst_max <= lim[0] and worst_mean <= lim[1]
    print(f"{label}: worst max rel err {worst_max:.2e} ({max_at}; limit "
          f"{lim[0]}), worst mean rel err {worst_mean:.2e} ({mean_at}; "
          f"limit {lim[1]}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} disagrees")
    return err


def _flat_grads(r):
    return [r[0], *[t for st in r[1] for t in st], r[2], r[3]]


def _flat_fwd(r):
    return [*r["zs"], r["features"], r["pooled"], r["idx"], r["sums"]]


def limits_chain(torch, dev, card):
    """K2, K3, K5 and K1 with split stages, bf16 and f32, at LIMITS_CHAIN
    against their plain versions (the chain and f32 phases' bounds); K5's
    forward and K1 array_equal to K2's; two launches equal.  Returns
    {dtype: {"K2": max abs, ...}}."""
    from wireframe_tpu_torch.ops.chain_grad import (
        chain_backward,
        chain_backward_plain,
        chain_forward,
        chain_forward_plain,
        remat_chain_backward,
        remat_chain_forward,
    )
    from wireframe_tpu_torch.ops.hopper_gemm import chain_plan
    from wireframe_tpu_torch.ops.fused_encoder import (
        fused_point_encoder,
        fused_point_encoder_plain,
    )

    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "f32" if dtype == torch.float32 else "bf16"
        err = errs[tag] = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K5 forward": 0.0,
                           "K5 backward": 0.0}
        for name, b, n, hidden, out, p, tile in LIMITS_CHAIN:
            label = f"{name} ({b}, {n}) {hidden}->{out} {tag}"
            if dtype == torch.float32:
                f32_plan_is_3xtf32(label, chain_plan(b * n, 8, hidden, out,
                                                     dtype))
            stages, fw, fb = recipe_encoder_params(
                torch, rng, dev, hidden=hidden, out=out, weight_dtype=dtype)
            x = torch.tensor(padded_clouds(rng, b, n), device=dev)
            kw = dict(kv_pool=p, compute_dtype=dtype, emit_features=True)
            k2 = chain_forward(x, stages, fw, fb, **kw)
            k5 = remat_chain_forward(x, stages, fw, fb, **kw)
            want = chain_forward_plain(x, stages, fw, fb, **kw)
            err["K2"] = max(err["K2"], _limits_fwd(
                torch, f"K2 {label}", dtype, k2, want))
            k1 = fused_point_encoder(x, stages, fw, fb, tile=tile, kv_pool=p,
                                     return_point_features=True,
                                     compute_dtype=dtype)
            k1p = fused_point_encoder_plain(x, stages, fw, fb, tile=tile,
                                            kv_pool=p,
                                            return_point_features=True,
                                            compute_dtype=dtype)
            close = f32_forward_close if dtype == torch.float32 \
                else forward_close
            err["K1"] = max(err["K1"], close(f"K1 {label}", k1, k1p,
                                             list(k1p)))
            again = chain_forward(x, stages, fw, fb, **kw)
            same = {"K5 forward == K2": all(torch.equal(k5[k], k2[k])
                                            for k in k5),
                    "K1 features == K5": torch.equal(k1["point_features"],
                                                     k5["features"]),
                    "K1 kv == K5": torch.equal(k1["kv_features"],
                                               k5["pooled"]),
                    "K2 twice": all(torch.equal(u, v) for u, v in zip(
                        _flat_fwd(again), _flat_fwd(k2)))}
            print(f"limits {label}: {same}", flush=True)
            if not all(same.values()):
                raise AssertionError(f"limits {label}: {same}")
            err["K5 forward"] = err["K2"]
            del k1, k1p, again, want
            # Cotangents; in f32 0 on the rows behind a near-tie gate and
            # the backward held against the plain one from the kernel's
            # own stash (see F32_GRAD_RTOL); in bf16 from one stash, as
            # the chain phase does.
            zs = k2["zs"]
            tied = f32_tied_rows(torch, x, stages, zs, p) \
                if dtype == torch.float32 else None
            keep = (~tied[0]).float().reshape(b, n, 1) if tied else \
                torch.ones((b, n, 1), device=dev)
            wkeep = keep.reshape(b, n // p, p, 1)[:, :, 0]
            cot = dict(dpool=torch.randn(k2["pooled"].shape, device=dev,
                                         generator=gen) * wkeep,
                       dsums=torch.randn(k2["sums"].shape, device=dev,
                                         generator=gen) * 0.1 * wkeep,
                       idx=k2["idx"],
                       g=torch.randn((b, n, out), device=dev,
                                     generator=gen) * 0.1 * keep)
            bkw = dict(kv_pool=p, compute_dtype=dtype, **cot)
            gp = chain_backward_plain(x, stages, fw, fb, zs, **bkw)
            for key, fn, remat in (
                    ("K3", lambda: chain_backward(x, stages, fw, fb, zs,
                                                  **bkw), False),
                    ("K5 backward", lambda: remat_chain_backward(
                        x, stages, fw, fb, **bkw), True)):
                ref = gp
                if remat and dtype == torch.bfloat16:
                    ref = chain_backward_plain(x, stages, fw, fb, None, **bkw)
                gk = fn()
                err[key] = max(err[key], _limits_bwd(
                    torch, f"{key} {label}", dtype, gk, ref, remat, tied))
                if not all(torch.equal(u, v) for u, v in zip(
                        _flat_grads(gk), _flat_grads(fn()))):
                    raise AssertionError(f"{key} {label}: two launches "
                                         "differ")
                del gk, ref
            del x, k2, k5, zs, gp, cot, keep
    return errs


def _rows_bound(nbytes):
    return nbytes / H100_BYTES_PER_S * 1e3, "bytes"


def _rows_close(torch, label, got, want, dtype, grad):
    """A row kernel's output against its plain version: in bf16 within one
    ulp of the row's largest magnitude (the stash check of the chain
    phase), in f32 within the f32 phase's forward or gradient bounds.
    Returns the largest absolute difference."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if dtype == torch.bfloat16:
        ok = bool((err <= bf16_ulp(torch, w.abs().amax(-1, keepdim=True)))
                  .all())
        rule = "one bf16 ulp of the row's max"
    elif grad:
        ok = bool((err <= F32_GRAD_ATOL * w.abs().max()
                   + F32_GRAD_RTOL * w.abs()).all())
        rule = f"rtol {F32_GRAD_RTOL}, atol {F32_GRAD_ATOL} of the max"
    else:
        ok = bool((err <= F32_FWD_ATOL + F32_FWD_RTOL * w.abs()).all())
        rule = f"rtol {F32_FWD_RTOL}, atol {F32_FWD_ATOL}"
    print(f"{label}: max_abs {err.max().item():.3e} ({rule}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} disagrees")
    return err.max().item()


# The row kernels alone at ragged shapes, against their plain versions:
# a width that is not a multiple of 8 (a tail of 4 bf16), a width whose
# units do not fill the last warp, an odd width (tails of 3), and a row
# past 8192 columns that streams in column chunks.
ROWS_RAGGED = ((1000, 4100), (656, 2312), (333, 2051), (300, 20002))


def _tie_free(torch, z, dh, g, be):
    """dh with 0 on the rows that hold a gate within F32_TIE of a tie
    (the two sides may open it differently; see F32_GRAD_RTOL), and the
    number of such rows."""
    zf = z.float()
    mu = zf.mean(-1, keepdim=True)
    xhat = (zf - mu) * torch.rsqrt(((zf - mu) ** 2).mean(
        -1, keepdim=True) + 1e-6)
    tied = ((xhat * g + be).abs() <= F32_TIE).any(-1, keepdim=True)
    return dh * (~tied).float(), int(tied.sum())


def limits_rows_ragged(torch, dev, card):
    """Each row kernel at ROWS_RAGGED in bf16 and f32 (the bf16 backward
    from the kernel's own stash and from the f32 z) against its plain
    version, within `_rows_close`'s bounds, two launches equal.  Returns
    {dtype: {"forward": largest error, "backward": largest error}}."""
    from wireframe_tpu_torch.ops._launch import row_buffer
    from wireframe_tpu_torch.ops.layernorm_rows import (
        layernorm_relu_backward,
        layernorm_relu_backward_plain,
        layernorm_relu_forward,
        layernorm_relu_forward_plain,
        rows_plan,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    errs = {tag: {"forward": 0.0, "backward": 0.0} for tag in ("bf16", "f32")}
    for m, w in ROWS_RAGGED:
        z = row_buffer(m, w, torch.float32, dev)
        z.copy_(torch.randn((m, w), device=dev, generator=gen) * 2 + 0.5)
        dh = row_buffer(m, w, torch.float32, dev)
        dh.copy_(torch.randn((m, w), device=dev, generator=gen) * 0.1)
        g = 1 + 0.1 * torch.randn(w, device=dev, generator=gen)
        be = 0.1 * torch.randn(w, device=dev, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            tag = "f32" if dtype == torch.float32 else "bf16"
            stash = None if dtype == torch.float32 else torch.bfloat16
            label = f"limits row kernels ({m}, {w}) {tag}"
            print(f"{label}: forward {rows_plan(m, w, dtype, 'fwd')['mode']},"
                  f" backward {rows_plan(m, w, dtype, 'bwd')['mode']}",
                  flush=True)
            hk, sk = layernorm_relu_forward(z, g, be, h_dtype=dtype,
                                            stash_dtype=stash)
            hp, sp = layernorm_relu_forward_plain(z, g, be, h_dtype=dtype,
                                                  stash_dtype=stash)
            err = errs[tag]
            err["forward"] = max(err["forward"], _rows_close(
                torch, f"{label} forward h", hk, hp, dtype, False))
            if sk is not None and not torch.equal(sk, sp):
                raise AssertionError(f"{label}: the stash is not z rounded")
            twice = [torch.equal(hk, layernorm_relu_forward(
                z, g, be, h_dtype=dtype, stash_dtype=stash)[0])]
            for zz in ((z,) if sk is None else (sk, z)):
                src = "f32 z" if zz.dtype == torch.float32 else "stash"
                d0, tied = _tie_free(torch, zz, dh, g, be)
                d = row_buffer(m, w, torch.float32, dev)
                d.copy_(d0)
                rebuild = zz is sk or dtype == torch.float32
                got = layernorm_relu_backward(zz, d, g, be, dz_dtype=dtype,
                                              rebuild_h=rebuild)
                want = layernorm_relu_backward_plain(
                    zz, d, g, be, dz_dtype=dtype, rebuild_h=rebuild)
                blabel = f"{label} backward from the {src}"
                err["backward"] = max(
                    err["backward"],
                    _rows_close(torch, f"{blabel} dz ({tied} tied rows "
                                "without cotangent)", got[0], want[0], dtype,
                                True),
                    _rows_close(torch, f"{blabel} column partials", got[2],
                                want[2], torch.float32, True))
                if rebuild:
                    err["backward"] = max(err["backward"], _rows_close(
                        torch, f"{blabel} h", got[1], want[1], dtype, False))
                again = layernorm_relu_backward(zz, d, g, be, dz_dtype=dtype,
                                                rebuild_h=rebuild)
                twice.append(all(u is None and v is None or torch.equal(u, v)
                                 for u, v in zip(got, again)))
            if not all(twice):
                raise AssertionError(f"{label}: two launches differ")
            # Times: the forward with K2's stash, the backward from the
            # stash (bf16) or the f32 z with the rebuilt h (K3).
            zb = z if sk is None else sk
            es = 4 if dtype == torch.float32 else 2
            for part, fn, nbytes in (
                    ("forward", lambda: layernorm_relu_forward(
                        z, g, be, h_dtype=dtype, stash_dtype=stash),
                     (4 + es + (0 if sk is None else 2)) * m * w + 8 * w),
                    ("backward", lambda: layernorm_relu_backward(
                        zb, d, g, be, dz_dtype=dtype, rebuild_h=True),
                     (3 * es + 4) * m * w + 8 * w
                     + 4 * -(-m // 128) * 3 * w)):
                ms = cuda_ms(torch, fn, 10)
                bound = _rows_bound(nbytes)[0]
                print(f"{label} {part}: kernel {ms:.4f} ms, bound "
                      f"{bound:.4f} ms (bytes), {bound / ms * 100:.1f}% of "
                      f"bound [{card}]", flush=True)
    print(f"limits row kernels at {list(ROWS_RAGGED)}: largest errors "
          f"{errs}; two launches equal [{card}]", flush=True)
    return errs


def rows_launches_per_call(torch, dev, card, m=2048, w=4096):
    """The kernels that one call of each row-kernel wrapper launches
    (forward bf16 and f32, backward bf16 and f32), counted on the device
    by name (`device_launches`): one each, or AssertionError."""
    from wireframe_tpu_torch.ops._launch import row_buffer
    from wireframe_tpu_torch.ops.layernorm_rows import (
        layernorm_relu_backward,
        layernorm_relu_forward,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    z = row_buffer(m, w, torch.float32, dev)
    z.copy_(torch.randn((m, w), device=dev, generator=gen))
    g = torch.ones(w, device=dev)
    be = torch.zeros(w, device=dev)
    _, stash = layernorm_relu_forward(z, g, be, h_dtype=torch.bfloat16,
                                      stash_dtype=torch.bfloat16)
    calls = {
        "forward bf16": lambda: layernorm_relu_forward(
            z, g, be, h_dtype=torch.bfloat16, stash_dtype=torch.bfloat16),
        "forward f32": lambda: layernorm_relu_forward(
            z, g, be, h_dtype=torch.float32),
        "backward bf16": lambda: layernorm_relu_backward(
            stash, z, g, be, dz_dtype=torch.bfloat16, rebuild_h=True),
        "backward f32": lambda: layernorm_relu_backward(
            z, z, g, be, dz_dtype=torch.float32, rebuild_h=False)}
    counts = {}
    for name, fn in calls.items():
        kernels = device_launches(torch, fn, ("ln_fwd_rows_kernel",
                                              "ln_bwd_rows_kernel"))
        counts[name] = sum(kernels.values())
    print(f"limits row kernels: kernel launches in one call of each "
          f"wrapper {counts} [{card}]", flush=True)
    if set(counts.values()) != {1}:
        raise AssertionError(f"row kernel launches per call: {counts}")
    return counts


def layernorm_alone(torch, z32, dh32, g, be):
    """The LayerNorm-alone yardsticks at the row kernels' shape: one
    `torch.nn.functional.layer_norm` (f32, eps 1e-6, affine) and one
    `torch.ops.aten.native_layer_norm_backward`, with the bytes each moves
    (input and output once: forward z, out; backward dh, z, dx, and
    d gamma, d beta).  Neither is the row kernels' function (no ReLU, no
    stash, no tie rule, no tile partials); the port never calls them."""
    m, w = z32.shape
    zc, dc = z32.contiguous(), dh32.contiguous()
    _, mean, rstd = torch.ops.aten.native_layer_norm(zc, [w], g, be, 1e-6)
    fwd = cuda_ms(torch, lambda: torch.nn.functional.layer_norm(
        zc, (w,), g, be, 1e-6), 10)
    bwd = cuda_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
        dc, zc, [w], mean, rstd, g, be, [True, True, True]), 10)
    return {"forward": (fwd, 8 * m * w + 8 * w),
            "backward": (bwd, 12 * m * w + 8 * m + 16 * w)}


def limits_timing(torch, dev, card):
    """At the recipe's (8, 2560) with the 4096 stage, bf16 and f32: the
    split stage forward (GEMM to f32 z + the LayerNorm row kernel, K2's
    stash) and backward (dh GEMM + the row kernels, K3's rebuilt h), and
    each row kernel alone, against their plain versions, with their
    bounds.  Returns {dtype: {"fwd": fields, "bwd": fields}}."""
    from wireframe_tpu_torch.ops import chain_grad
    from wireframe_tpu_torch.ops._launch import tma_rows
    from wireframe_tpu_torch.ops.fused_encoder import dot, ln
    from wireframe_tpu_torch.ops.hopper_gemm import chain_plan
    from wireframe_tpu_torch.ops.layernorm_rows import (
        layernorm_relu_backward,
        layernorm_relu_backward_plain,
        layernorm_relu_forward,
        layernorm_relu_forward_plain,
    )

    from wireframe_tpu_torch.ops.layernorm_rows import occupancy, rows_plan

    rng = np.random.default_rng(18)
    m, k_in, width = 8 * 2560, 1024, 4096
    out = {}
    alone = None
    for dtype in (torch.bfloat16, torch.float32):
        tag = "f32" if dtype == torch.float32 else "bf16"
        f32 = dtype == torch.float32
        es = 4 if f32 else 2
        (w, bb, g, be), (wa, *_) = recipe_encoder_params(
            torch, rng, dev, input_dim=k_in, hidden=(width, k_in),
            weight_dtype=dtype)[0]
        layer = (tma_rows(w, dtype), bb, g, be)
        a = tma_rows(torch.randn((m, k_in), device=dev), dtype)
        dza = tma_rows(torch.randn((m, k_in), device=dev) * 0.1, dtype)
        wa = tma_rows(wa, dtype)
        lib = chain_grad._lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        zdt = torch.float32 if f32 else torch.bfloat16
        stage_fwd = lambda: chain_grad._stage_forward(  # noqa: E731
            lib, a, k_in, layer, m, stream, z_dtype=zdt, what="split stage")
        h, z = stage_fwd()
        plan = chain_plan(m, 8, (width, k_in), 512, dtype)
        stage_bwd = lambda: chain_grad._stage_backward(  # noqa: E731
            lib, dza, wa, k_in, z, layer, m, plan, True, stream,
            "split stage backward")

        def plain_fwd():
            zz = dot(a, w, dtype) + bb
            return torch.clamp_min(ln(zz, g, be), 0.0).to(dtype), \
                zz.to(dtype)

        def plain_bwd():
            dh = dot(dza, wa.t(), dtype)
            return layernorm_relu_backward_plain(z, dh, g, be, dz_dtype=dtype,
                                                 rebuild_h=True)

        z32 = torch.empty((m, width), device=dev)
        z32.copy_(dot(a, w, dtype) + bb)
        dh32 = dot(dza, wa.t(), dtype)
        stash = None if f32 else torch.bfloat16
        rows_fwd = lambda: layernorm_relu_forward(  # noqa: E731
            z32, g, be, h_dtype=dtype, stash_dtype=stash)
        rows_bwd = lambda: layernorm_relu_backward(  # noqa: E731
            z, dh32, g, be, dz_dtype=dtype, rebuild_h=True)
        hk, _ = rows_fwd()
        hp, _ = layernorm_relu_forward_plain(z32, g, be, h_dtype=dtype,
                                             stash_dtype=stash)
        fwd_err = _rows_close(torch, f"limits row kernel forward {tag} h",
                              hk, hp, dtype, False)
        dh32, tied = _tie_free(torch, z, dh32, g, be)
        print(f"limits row kernel backward {tag}: cotangent 0 on "
              f"{tied} of {m} rows behind a gate within {F32_TIE} of a "
              "tie", flush=True)
        dzk, hbk, pk = rows_bwd()
        dzp, hbp, pp = layernorm_relu_backward_plain(
            z, dh32, g, be, dz_dtype=dtype, rebuild_h=True)
        bwd_err = max(
            _rows_close(torch, f"limits row kernel backward {tag} dz", dzk,
                        dzp, dtype, True),
            _rows_close(torch, f"limits row kernel backward {tag} h", hbk,
                        hbp, dtype, False),
            _rows_close(torch, f"limits row kernel backward {tag} column "
                        "partials", pk, pp, torch.float32, True))
        for direction, zdt in (("fwd", None), ("bwd", z.dtype)):
            rplan = rows_plan(m, width, dtype, direction, zdt)
            print(f"limits row kernel {direction} {tag} plan: "
                  + ", ".join(f"{k} {rplan[k]}" for k in (
                      "mode", "threads", "ring", "rows_per_cta", "cluster",
                      "grid", "smem_bytes", "ctas_per_sm"))
                  + f"; the runtime fits {occupancy(rplan, dtype, zdt)} "
                  + ("clusters on the card" if direction == "bwd"
                     else "blocks an SM"), flush=True)
        if alone is None:
            alone = layernorm_alone(torch, z32, dh32, g, be)
        tiles = -(-m // 128)
        res = {}
        for key, fn, plain, flops, nbytes in (
                ("split stage forward", stage_fwd, plain_fwd,
                 2.0 * m * k_in * width,
                 es * (m * k_in + k_in * width + 2 * m * width) + 12 * width),
                ("split stage backward", stage_bwd, plain_bwd,
                 2.0 * m * k_in * width,
                 es * (m * k_in + k_in * width + 3 * m * width)
                 + 8 * width + 4 * tiles * 3 * width),
                ("row kernel forward", rows_fwd,
                 lambda: layernorm_relu_forward_plain(
                     z32, g, be, h_dtype=dtype, stash_dtype=stash),
                 0.0, (4 + es + (0 if f32 else 2)) * m * width + 8 * width),
                ("row kernel backward", rows_bwd,
                 lambda: layernorm_relu_backward_plain(
                     z, dh32, g, be, dz_dtype=dtype, rebuild_h=True),
                 0.0, (3 * es + 4) * m * width + 8 * width
                 + 4 * tiles * 3 * width)):
            ms = cuda_ms(torch, fn, 10)
            plain_ms = cuda_ms(torch, plain, 3)
            bound, by = (_bound(flops, nbytes, f32) if flops
                         else _rows_bound(nbytes))
            yard = ""
            res[key] = {"shape": f"M={m} K={k_in} W={width}", "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by}
            if key.startswith("row kernel"):
                lms, lbytes = alone[key.split()[-1]]
                yard = (f"LayerNorm alone — not the same function (f32 "
                        f"torch call): {lms:.4f} ms, "
                        f"{lbytes / H100_BYTES_PER_S * 1e3 / lms * 100:.1f}% "
                        f"of its own {lbytes / 1e6:.1f} MB at 3.35 TB/s")
                res[key]["layernorm_alone_ms"] = lms
            print(f"limits {key} {tag} ({m} x {k_in} -> {width}): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), {bound / ms * 100:.1f}% of bound;"
                  f" library: {yard or 'none'} [{card}]", flush=True)
        res["row kernel forward"]["max_abs_err"] = fwd_err
        res["row kernel backward"]["max_abs_err"] = bwd_err
        out[tag] = res
        del a, dza, z32, dh32, h, z, hk, hp, dzk, dzp, hbk, hbp, pk, pp
    ragged = limits_rows_ragged(torch, dev, card)
    rows_launches_per_call(torch, dev, card)
    for tag in out:
        for part in ("forward", "backward"):
            out[tag][f"row kernel {part}"]["ragged_max_abs_err"] = \
                ragged[tag][part]
    return out


def limits_phase(torch, dev, card, work):
    """Every shape the JAX kernels take, within LIMITS_BUDGET_S: (a) the
    recipe at data.max_vertices=256 (K4's (8, 256, 256) with the costs in
    device memory), served one batch per bucket and trained 5 steps; (b)
    the recipe with a 4096-wide encoder stage (split: K1 serving, K2 / K3
    training); (c) the parity model as shipped (f32) with that stage, 3
    steps through K5 f32 and K4; then K4 at its new shapes and the chain
    kernels with split stages alone, and the split stages and row kernels
    timed.  Returns the fields of the kernels line."""
    t0 = time.perf_counter()
    paths = _limits_paths(work)
    steps = LIMITS_STEPS
    out = {}
    out["a served"], out["a"] = _limits_recipe(
        torch, dev, card, work, "(a)", ["data.max_vertices=256"], paths,
        {"K2": steps, "K3": steps, "K4": steps,
         "K4 warp, costs in global memory": steps})
    out["b served"], out["b"] = _limits_recipe(
        torch, dev, card, work, "(b)", [WIDE_SET], paths,
        {"K2": steps, "K3": steps, "K4": steps, "LN rows fwd": steps,
         "LN rows bwd": steps, "K4 warp, costs in shared memory": steps})
    out["c"] = _limits_parity_f32(torch, dev, card)
    out["K4"] = limits_k4(torch, dev, card)
    out["chain"] = limits_chain(torch, dev, card)
    out["timing"] = limits_timing(torch, dev, card)
    secs = time.perf_counter() - t0
    print(f"limits phase: {secs:.1f} s (budget {LIMITS_BUDGET_S:.0f} s) "
          f"[{card}]", flush=True)
    if secs > LIMITS_BUDGET_S:
        raise AssertionError(f"the limits phase took {secs:.1f} s")
    return out


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
    train_counts = launch_counts(MAIN_KEYS)
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
        n = launch_counts(MAIN_KEYS)["K1"]
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
    n = launch_counts(MAIN_KEYS)["K1"]
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
    k1 = launch_counts(MAIN_KEYS)["K1"]
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
    return ([r["total_loss"] for r in writer.rows], launch_counts(MAIN_KEYS),
            state)


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
    through `evaluate --torch-checkpoint` in f32 (the plain encoder), in
    bf16 through K1 and in f32 through K1; a scanned, fused recipe
    checkpoint with its Adam state resumed twice to the same losses.
    Returns {kernel: launches on this path}."""
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
    counts, lines, verts, f32_counts = {}, {}, {}, {}
    for label, extra in (("f32", []), ("bf16 K1", PARITY_SET),
                         ("f32 K1", ["model.use_pallas_encoder=true"])):
        reset_launches()
        t0 = time.perf_counter()
        lines[label], verts[label] = _eval_vertices(evaluate_cli,
                                                    argv + _sets(extra))
        torch.cuda.synchronize()
        counts[label] = launch_counts(MAIN_KEYS)
        f32_counts[label] = launch_counts(F32_KEYS)
        print(f"checkpoints: evaluate --torch-checkpoint ({label}) "
              f"{time.perf_counter() - t0:.2f} s, {len(verts[label])} "
              f"forward batches; launches {counts[label]}, f32 "
              f"{f32_counts[label]} [{card}]", flush=True)
        values = [float(ln.split()[-1]) for ln in lines[label]
                  if ln.split() and ln.split()[0] in (
                      "Wireframe", "Average", "Corners", "Edges")]
        if len(values) != 8 or not all(map(math.isfinite, values)):
            raise AssertionError(f"evaluate ({label}) metrics {values}")
    batches = len(verts["bf16 K1"])
    want = {"f32": 0, "bf16 K1": batches, "f32 K1": 0}
    want_f32 = {"f32": 0, "bf16 K1": 0, "f32 K1": batches}
    if any(counts[k]["K1"] != n for k, n in want.items()) or any(
            v for c in counts.values() for k, v in c.items() if k != "K1"):
        raise AssertionError(f"evaluate launches {counts}")
    if any(f32_counts[k]["K1 f32"] != n for k, n in want_f32.items()) or any(
            v for c in f32_counts.values() for k, v in c.items()
            if k != "K1 f32"):
        raise AssertionError(f"evaluate f32 launches {f32_counts}")
    err = max(float(np.abs(a - b).max())
              for a, b in zip(verts["f32"], verts["bf16 K1"]))
    print(f"checkpoints: .pth model vertices, bf16 with K1 against f32 "
          f"plain: max abs diff {err:.3e} (atol "
          f"{MODEL_ATOL['vertices']})", flush=True)
    if len(verts["f32"]) != batches or err > MODEL_ATOL["vertices"]:
        raise AssertionError("the .pth model's bf16 K1 vertices differ")
    err = max(float(np.abs(a - b).max())
              for a, b in zip(verts["f32"], verts["f32 K1"]))
    print(f"checkpoints: .pth model vertices, f32 with K1 against f32 "
          f"plain: max abs diff {err:.3e} (atol {F32_FWD_ATOL})", flush=True)
    if len(verts["f32 K1"]) != batches or err > F32_FWD_ATOL:
        raise AssertionError("the .pth model's f32 K1 vertices differ")

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
    train_counts = launch_counts(MAIN_KEYS)
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
    return {**{k: counts["bf16 K1"][k] + train_counts[k]
               for k in train_counts},
            "K1 f32": f32_counts["f32 K1"]["K1 f32"]}


# ---------------------------------------------------------------------------
# Parser: the C++ .xyz parser on the corpus; the adjacency ops on the card
# ---------------------------------------------------------------------------

PARSER_PASSES = 3


def parser_phase(torch, dev, card, work):
    """Every .xyz of the corpus phase's corpus through the native parser
    and np.loadtxt (array_equal, float64, ms per file); every cloud read
    so far in this run went through the native parser; the adjacency ops
    on one served batch of the corpus's trained model, on the card."""
    import glob

    from wireframe_tpu_torch.eval.evaluator import make_forward_fn
    from wireframe_tpu_torch.io import native, xyz
    from wireframe_tpu_torch.ops.adjacency import (
        adjacency_from_edge_probs,
        edge_probs_from_adjacency,
    )
    from wireframe_tpu_torch.train.checkpoint import load_checkpoint

    if not native.loaded():
        raise AssertionError(f"the native parser is not loaded: "
                             f"{native.error()}")
    reads = dict(xyz.READS)
    print(f"parser: {native.library_path().name} loaded; reads so far in "
          f"this run {reads}", flush=True)
    if reads["numpy"] or not reads["native"]:
        raise AssertionError(f"a cloud fell back to np.loadtxt: {reads}")
    files = sorted(glob.glob(os.path.join(work, "corpus", "*", "xyz",
                                          "*.xyz")))
    secs = {"native": 0.0, "np.loadtxt": 0.0}
    for _ in range(PARSER_PASSES):
        t0 = time.perf_counter()
        got = [xyz.read_xyz(f) for f in files]
        secs["native"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [np.loadtxt(f, dtype=np.float64, ndmin=2) for f in files]
        secs["np.loadtxt"] += time.perf_counter() - t0
        for f, a, b in zip(files, got, want):
            if a.dtype != np.float64 or not np.array_equal(a, b):
                raise AssertionError(f"{f}: the parsers differ")
    if xyz.READS["numpy"] != 0:
        raise AssertionError(f"a corpus file fell back: {xyz.READS}")
    ms = {k: v / (PARSER_PASSES * len(files)) * 1e3 for k, v in secs.items()}
    points = sum(len(a) for a in got)
    print(f"parser: {len(files)} corpus files ({points} points), "
          f"{PARSER_PASSES} passes, array_equal float64; ms per file: "
          f"native {ms['native']:.3f}, np.loadtxt {ms['np.loadtxt']:.3f}, "
          f"ratio {ms['np.loadtxt'] / ms['native']:.2f}x [{card}]",
          flush=True)

    # Adjacency on one served batch: the corpus phase's EMA checkpoint
    # serves the 8 test clouds; its pair probabilities go to the card.
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import (
        Building3DDataset,
        collate_fixed,
    )

    payload, _ = load_checkpoint(os.path.join(work, "corpus_ckpt", "ema"))
    cfg = load_config(RECIPE, [f"data.root_dir={os.path.join(work, 'corpus')}"])
    test_ds = Building3DDataset(cfg.data, "test")
    samples = [test_ds.get_sample(i, rng=np.random.default_rng(
        (cfg.data.seed, i)), augment_on_host=False)
        for i in range(len(test_ds))]
    out = make_forward_fn(cfg, payload["params"], dev)(
        collate_fixed(samples, cfg.model.max_vertices)["point_clouds"])
    p = torch.from_numpy(out["edge_probs"]).to(dev)
    v = cfg.model.max_vertices
    for t in (0.5, float(p.median())):
        adj = adjacency_from_edge_probs(p, v, t)
        back = edge_probs_from_adjacency(adj)
        on = (p > t).to(torch.float32)
        ok = (adj.device.type == dev.type and torch.equal(back, on)
              and torch.equal(adj, adj.transpose(1, 2)))
        print(f"parser: adjacency round trip on the card, batch "
              f"{tuple(p.shape)}, V {v}, t {t:.6f}: {int(on.sum())} pairs "
              f"on, equal to (p > t) {ok}", flush=True)
        if not ok:
            raise AssertionError("the adjacency round trip differs")


# ---------------------------------------------------------------------------
# Study: the port's seed study and study report on the corpus
# ---------------------------------------------------------------------------

STUDY_SEEDS = (0, 1)
STUDY_EPOCHS = 2


def study_phase(torch, dev, card, work):
    """`tools.seed_study` over the corpus phase's corpus (seeds 0 and 1,
    2 epochs, EMA and decoded, the default device: every subprocess on
    CUDA), then `tools.study_report` on its records."""
    from wireframe_tpu_torch.tools import seed_study, study_report

    out = os.path.join(work, "study")
    argv = ["--config", RECIPE, "--data-root", os.path.join(work, "corpus"),
            "--out", out, "--seeds", ",".join(map(str, STUDY_SEEDS)),
            "--tag", "s", "--set", f"train.num_epochs={STUDY_EPOCHS}",
            "--eval-ema", "--decoded"]
    said = []
    for main_fn, args in ((seed_study.main, argv), (study_report.main, [
            "--results", os.path.join(out, "results.jsonl"),
            "--control", "s:ema", "--tags", "s:final"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main_fn(args)
        said.append(buf.getvalue())
        print(said[-1].rstrip(), flush=True)
        if rc != 0:
            raise AssertionError(f"{main_fn.__module__} returned {rc}")
    with open(os.path.join(out, "results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    got = sorted((r["seed"], r["variant"]) for r in rows)
    want = sorted((s, v) for s in STUDY_SEEDS
                  for v in ("final", "ema", "decoded"))
    # A failed subprocess raises (train, evaluate) or leaves its decoded
    # record out with a warning (calibration): 6 records, no warning.
    if got != want or "WARNING" in said[0]:
        raise AssertionError(f"seed_study records {got}, expected {want}")
    if any(r["device"] != card for r in rows):
        raise AssertionError(f"records name {[r['device'] for r in rows]}, "
                             f"not {card}")
    if f"Paired vs control `s:ema` (n={len(STUDY_SEEDS)} seeds)" not in said[1]:
        raise AssertionError("study_report did not pair the seeds")
    print(f"study: {len(rows)} records, each on {card}", flush=True)


# ---------------------------------------------------------------------------

PARALLEL_SHARDS = 4
PARALLEL_NCCL_STEPS = 3
PARALLEL_STEPS = 5
PARALLEL_POOLS = (3, 16384)
PARALLEL_POOL_TILE = 512            # K1's tile in the K1 phase
PARALLEL_BUDGET_S = 90.0
PARALLEL_SEED = 5
# Two ranks (8 rows each) against one process on the global batch of
# 16, step 1: the JAX package's own bounds for a mesh step against the
# one-device step (tests/test_sharding.py:228-284), the elementwise
# losses at bf16's rtol 1e-4; the vertex loss 1e-2, that test's allowance
# for a matcher near-tie.
DP_RTOL = {"existence_loss": 1e-4, "edge_loss": 1e-4, "vertex_loss": 1e-2}
# Params after step k: Adam moves a parameter by at most about lr a step
# (exactly at most lr at step 1, where the update is lr times the
# gradient's sign; |mu_hat| / sqrt(nu_hat) stays within 1.01 over the
# first 5 steps at b1 0.9, b2 0.999), so two runs whose gradients differ
# only in float noise differ by at most 2 k lr after k steps; 5% slack.
DP_PARAM_STEP_LRS = 2.1
# Step 1's first moment (0.1 x the clipped gradient) against the one
# process's: ||mu - mu_ref|| / ||mu_ref|| over every parameter.  The ranks
# sum the same products in another order (f32) and bf16 GEMMs of other
# row counts may round otherwise; a gradient counted twice would read
# about 1.
DP_MU_REL = 1e-2
# (e): point-parallel training at dp = 1 x mp = 2 on the same two ranks.
MP_STEPS = 3
MP_RECIPE_ROWS = 8
MP_PARITY_ROWS = 3


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The command line of one rank (`rank_main`), from the repository root.
RANK_ARGV = ["-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.rank_main(sys.argv[1]))"]


def _run_ranks(task, world, work, timeout):
    """Start `rank_main(task)` as `world` processes with torchrun's
    environment (a free localhost port); echo their output; fail on a
    rank's non-zero exit or timeout.  Returns each rank's result."""
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CHIP_SMOKE_OUT=os.path.join(
                       work, f"{task}_{rank}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, *RANK_ARGV, task],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.rstrip().splitlines():
            print(f"  [{task} rank {rank}] {line}", flush=True)
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        raise AssertionError(f"{task} ranks exited non-zero: {failed}")
    results = []
    for rank in range(world):
        with open(os.path.join(work, f"{task}_{rank}.json")) as f:
            results.append(json.load(f))
    return results


def _sharded_eval(torch, dev, card, work):
    """`evaluate --sharded 4` of the corpus phase's EMA checkpoint, shard
    by shard and pipelined, against the plain runs: counters
    array_equal; K1 launches; clouds/s.  Returns K1's launches."""
    from wireframe_tpu_torch import evaluate as evaluate_cli
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.data.building3d import Building3DDataset
    from wireframe_tpu_torch.eval.distributed import counters_vector
    from wireframe_tpu_torch.train.checkpoint import (
        apply_checkpoint_model_config,
        load_checkpoint,
    )

    root = os.path.join(work, "corpus")
    ema = os.path.join(work, "corpus_ckpt", "ema")
    cfg = load_config(RECIPE, [f"data.root_dir={root}"])
    payload, meta = load_checkpoint(ema)
    apply_checkpoint_model_config(cfg, meta)
    test_ds = Building3DDataset(cfg.data, "test")
    n = len(test_ds)
    vthresh, ethresh = _eval_thresholds(torch, cfg, payload["params"],
                                        test_ds, dev)
    base = (["--config", RECIPE, "--data-root", root, "--checkpoint-dir",
             ema, "--device", str(dev)]
            + _sets([f"eval.vertex_existence_thresh={vthresh!r}",
                     f"eval.edge_confidence_thresh={ethresh!r}",
                     "eval.batch_size=8"]))
    per_shard = -(-n // PARALLEL_SHARDS)
    k1 = 0
    for path, extra, forwards in (
            ("shard by shard", [], {"plain": 1, "sharded": PARALLEL_SHARDS}),
            ("pipelined", ["--pipelined", "--eval-batch", "8"],
             {"plain": 1, "sharded": 1})):
        vecs = {}
        for run, flags in (("plain", []),
                           ("sharded", ["--sharded", str(PARALLEL_SHARDS)])):
            reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                ap = evaluate_cli.run(base + extra + flags)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = launch_counts(MAIN_KEYS)["K1"]
            if run == "sharded":
                k1 += launches
            vecs[run] = counters_vector(ap)
            print(f"parallel (a) evaluate {path} {run}"
                  f"{f' --sharded {PARALLEL_SHARDS}' if flags else ''}: "
                  f"{n / secs:.2f} clouds/s (CLI wall {secs:.2f} s over {n} "
                  f"clouds, {per_shard} a shard); K1 launches {launches} "
                  f"for {forwards[run]} forward batches [{card}]",
                  flush=True)
            if launches != forwards[run]:
                raise AssertionError(f"evaluate {path} {run}: {launches} K1 "
                                     "launches")
        same = bool(np.array_equal(vecs["sharded"], vecs["plain"]))
        print(f"parallel (a) {path}: counters {vecs['sharded'].tolist()}, "
              f"array_equal to the plain run's {same}", flush=True)
        if not same:
            raise AssertionError(f"sharded {path} counters "
                                 f"{vecs['sharded']} != {vecs['plain']}")
    return k1


def parallel_phase(torch, dev, card, work):
    """More than one device on one card: (a) sharded eval in this
    process; (b) the dp step through a real NCCL group of one rank; (c)
    two ranks over gloo on the card against one process; (d) point-
    sharded pooling at mp = 2 through K1.  Returns {kernel: launches}."""
    t0 = time.perf_counter()
    launches = dict.fromkeys(MAIN_KEYS, 0)
    launches["K1"] += _sharded_eval(torch, dev, card, work)

    (nccl,) = _run_ranks("nccl", 1, work, timeout=PARALLEL_BUDGET_S)
    print(f"parallel (b) NCCL, world size 1, {nccl['batch']}: params "
          f"array_equal to the plain step's after each of "
          f"{PARALLEL_NCCL_STEPS} steps {nccl['equal']}; ms per dp step "
          f"{nccl['ms']} (plain {nccl['plain_ms']}) [{card}]", flush=True)
    print(f"parallel (b) collective audit of a dp step: {nccl['audit']}",
          flush=True)
    if not all(nccl["equal"]):
        raise AssertionError("the NCCL dp step moved the params off the "
                             "plain step's")
    if nccl["step_launches"] != [{"K2": 1, "K3": 1, "K4": 1}] * \
            PARALLEL_NCCL_STEPS:
        raise AssertionError(f"NCCL dp step launches "
                             f"{nccl['step_launches']}")

    print(f"parallel (c)/(e) bounds: step-1 losses rtol {DP_RTOL}; step-1 "
          f"first moment ||mu - mu_ref|| / ||mu_ref|| <= {DP_MU_REL}; params "
          f"after step k within {DP_PARAM_STEP_LRS} k lr.  Prediction for "
          f"(e): the gathered KV tokens array_equal to the one-process "
          f"K2's (the chain is per point, the slice boundary is a multiple "
          f"of the 256-row tile and of kv_pool, and a wgmma row's K order "
          f"does not depend on M); step-1 losses within 1e-5 relative "
          f"(only the masked mean's window sums add in another order); "
          f"the first moment within 1e-3 relative [{card}]", flush=True)
    ranks = _run_ranks("gloo", 2, work, timeout=PARALLEL_BUDGET_S)
    first = ranks[0]
    print(f"parallel (c) two ranks over gloo on one card, global batch "
          f"{first['batch']}: step 1 losses {first['dp_losses']} vs one "
          f"process {first['ref_losses']} (rtol {DP_RTOL}); step 1 first "
          f"moment relative L2 difference {first['mu_rel']} (bound "
          f"{DP_MU_REL}); largest param difference after steps "
          f"1..{PARALLEL_STEPS} {first['param_diff']} (bounds "
          f"{first['param_bounds']}); ms per step, two ranks sharing the "
          f"card (contended, not scaling) {[r['ms'] for r in ranks]}, one "
          f"process at 16 rows {first['ref_ms']} [{card}]", flush=True)
    for r, res in enumerate(ranks):
        want = [{"K2": 1, "K3": 1, "K4": 1}] * PARALLEL_STEPS
        if res["step_launches"] != want:
            raise AssertionError(f"rank {r} launches per dp step "
                                 f"{res['step_launches']}")
        for k in ("K2", "K3", "K4"):
            launches[k] += sum(s[k] for s in res["step_launches"])
        if res["pool_launches"] != 1:
            raise AssertionError(f"rank {r}: K1 launched "
                                 f"{res['pool_launches']} times in (d)")
        launches["K1"] += res["pool_launches"]
    for k in ("K2", "K3", "K4"):
        launches[k] += sum(s[k] for s in nccl["step_launches"])
    print(f"parallel (d) sharded_point_pools at mp=2, {PARALLEL_POOLS}: "
          f"largest difference from the unsharded K1 call "
          f"{first['pool_err']} (K1's tolerance rtol {K1_RTOL} atol "
          f"{K1_ATOL}) [{card}]", flush=True)
    mp_launches = [{k: 0 for k in launches} for _ in ranks]
    for name in ("recipe", "parity"):
        res = first["mp"][name]
        print(f"parallel (e) {name} at dp=1 x mp=2 over gloo on one card, "
              f"{res['batch']} ({res['slice']} a rank): "
              + (f"gathered KV array_equal to one process's K2 "
                 f"{res['kv_equal']} (largest difference "
                 f"{res['kv_diff']}); " if "kv_equal" in res else "")
              + f"step 1 losses {res['losses']} vs one process "
              f"{res['ref_losses']}; first moment relative L2 "
              f"{res['mu_rel']}; largest param difference after steps "
              f"1..{MP_STEPS} {res['param_diff']} (bounds "
              f"{res['param_bounds']}); ms per step, two ranks sharing the "
              f"card (time-shared, not a scaling figure) "
              f"{[r['mp'][name]['ms'] for r in ranks]}, one process "
              f"{res['ref_ms']}; launches per rank "
              f"{[r['mp'][name]['launches'] for r in ranks]} [{card}]",
              flush=True)
        for r, rres in enumerate(ranks):
            for k, v in rres["mp"][name]["launches"].items():
                mp_launches[r][k] += v
                launches[k] += v
    for r, counts in enumerate(mp_launches):
        want = {"K1": 0, "K2": MP_STEPS, "K3": MP_STEPS, "K4": 2 * MP_STEPS,
                "K5 fwd": MP_STEPS, "K5 bwd": MP_STEPS}
        if counts != want:
            raise AssertionError(f"rank {r} (e) launches {counts}, expected "
                                 f"{want}")
    launches["mp_per_rank"] = mp_launches
    secs = time.perf_counter() - t0
    print(f"parallel phase: {secs:.1f} s (budget {PARALLEL_BUDGET_S:.0f} s); "
          f"launches {launches} [{card}]", flush=True)
    if secs > PARALLEL_BUDGET_S:
        raise AssertionError(f"parallel phase took {secs:.1f} s")
    return launches


def _rank_setup(torch, backend, device):
    """Join the group the environment describes; the card's settings as
    main() sets them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from wireframe_tpu_torch.parallel.mesh import init_distributed

    return init_distributed(backend=backend, device=device)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _nccl_rank(torch):
    """(b): the recipe's dp step through an NCCL group of one rank against
    the plain step, batch 8 x 2560, constant LR (so the updates are not
    0), 3 steps: the params must be array_equal after each."""
    import torch.distributed as dist

    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.parallel.collective_audit import (
        audit_train_step_collectives,
    )
    from wireframe_tpu_torch.train.loop import device_batch, init_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.synth import make_box_building_batch

    dev = _rank_setup(torch, None, None)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"{dist.get_backend()} x "
                             f"{dist.get_world_size()}, not NCCL x 1")
    cfg = load_config(RECIPE, ["train.lr_schedule=constant"])
    batch = device_batch(make_box_building_batch(
        cfg, cfg.train.batch_size, seed=PARALLEL_SEED), dev)
    plain = create_train_state(cfg, init_model(cfg, dev, seed=SERVE_SEED))
    dp = create_train_state(cfg, init_model(cfg, dev, seed=SERVE_SEED))
    step = make_train_step(cfg)
    equal, ms, plain_ms, step_launches, audit = [], [], [], [], None
    for i in range(PARALLEL_NCCL_STEPS):
        _, t = _timed(torch, lambda: step(
            plain, batch, torch.Generator(device=dev).manual_seed(i)))
        plain_ms.append(round(t, 2))
        reset_launches()
        (log, _), t = _timed(torch, lambda: audit_train_step_collectives(
            cfg, dp, batch, torch.Generator(device=dev).manual_seed(i)))
        ms.append(round(t, 2))
        counts = launch_counts(MAIN_KEYS)
        step_launches.append({k: counts[k] for k in ("K2", "K3", "K4")})
        audit = audit or [(c.op, c.dtype, list(c.shape), c.bytes)
                          for c in log]
        equal.append(all(torch.equal(a, b) for a, b in zip(
            plain.model.parameters(), dp.model.parameters())))
    b, n = batch["point_clouds"].shape[:2]
    return {"equal": equal, "ms": ms, "plain_ms": plain_ms,
            "audit": audit, "batch": f"{b} x {n}",
            "step_launches": step_launches}


def _gloo_rank(torch):
    """(c) and (d) on one rank of two sharing the card over gloo."""
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.ops.fused_encoder import fused_point_encoder
    from wireframe_tpu_torch.parallel.collective_audit import all_reduce
    from wireframe_tpu_torch.parallel.mesh import Layout, local_rows, world
    from wireframe_tpu_torch.parallel.multihost import replicate_across_hosts
    from wireframe_tpu_torch.parallel.sharded_pool import sharded_point_pools
    from wireframe_tpu_torch.train.loop import device_batch, init_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.synth import (
        make_box_building_batch,
        targets_near_slots,
    )

    dev = _rank_setup(torch, "gloo", "cuda:0")
    rank, size = world()
    # The shipped recipe at full width, 8 rows a rank; dropout off (the
    # masks are drawn on each rank's own shapes), device augmentation on,
    # constant LR so that step 1 moves the params.
    cfg = load_config(RECIPE, ["train.lr_schedule=constant",
                               "model.attn_dropout=0", "model.edge_dropout=0",
                               f"train.batch_size={8 * size}"])
    model = init_model(cfg, dev, seed=SERVE_SEED)
    batch = targets_near_slots(cfg, model, make_box_building_batch(
        cfg, cfg.train.batch_size, seed=PARALLEL_SEED), PARALLEL_SEED,
        device=dev)
    state = create_train_state(cfg, model)
    for tree in (state.model, state.mu, state.nu, state.ema_params):
        replicate_across_hosts(tree)
    out = {"batch": f"{cfg.train.batch_size} x {cfg.data.num_points}",
           "ms": [], "step_launches": [], "param_diff": [], "ref_ms": []}
    if rank == 0:
        # One process on the global batch, each step's params kept.
        ref = create_train_state(cfg, init_model(cfg, dev, seed=SERVE_SEED))
        ref_step = make_train_step(cfg)
        ref_batch = device_batch(batch, dev)
        ref_gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
        ref_params = []
        for i in range(PARALLEL_STEPS):
            (_, m), t = _timed(torch, lambda: ref_step(ref, ref_batch,
                                                       ref_gen))
            out["ref_ms"].append(round(t, 2))
            ref_params.append([p.detach().clone()
                               for p in ref.model.parameters()])
            if i == 0:
                out["ref_losses"] = {k: float(m[k]) for k in DP_RTOL}
                ref_mu = [t.clone() for t in ref.mu.values()]
        del ref
    all_reduce(torch.zeros(1, device=dev))      # rank 0's reference done
    step = make_train_step(cfg, layout=Layout.of_group())
    mine = device_batch(local_rows(batch, rank, size), dev)
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
    for i in range(PARALLEL_STEPS):
        reset_launches()
        (_, m), t = _timed(torch, lambda: step(state, mine, gen))
        out["ms"].append(round(t, 2))
        counts = launch_counts(MAIN_KEYS)
        out["step_launches"].append({k: counts[k] for k in ("K2", "K3",
                                                            "K4")})
        if rank == 0:
            if i == 0:
                out["dp_losses"] = {k: float(m[k]) for k in DP_RTOL}
                _check_losses(out["dp_losses"], out["ref_losses"])
                out["mu_rel"] = _check_mu(state.mu.values(), ref_mu)
            _check_params(cfg, out, i, state.model.parameters(),
                          ref_params[i])

    # (d) point-sharded pools at mp = 2 through K1, each rank its half.
    rng = np.random.default_rng(PARALLEL_SEED)
    stages, fw, fb = recipe_encoder_params(torch, rng, dev)
    x = torch.tensor(padded_clouds(rng, *PARALLEL_POOLS), device=dev)
    reset_launches()
    pools = sharded_point_pools(x, stages, fw, fb, tile=PARALLEL_POOL_TILE)
    torch.cuda.synchronize()
    out["pool_launches"] = launch_counts(MAIN_KEYS)["K1"]
    if rank == 0:
        whole = fused_point_encoder(x, stages, fw, fb,
                                    tile=PARALLEL_POOL_TILE)
        err = 0.0
        for k, got in pools.items():
            want = whole[k]
            err = max(err, float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL):
                raise AssertionError(f"sharded pool {k} differs from K1's")
        out["pool_err"] = err

    out["mp"] = _mp_ranks(torch, dev, rank)
    return out


def _check_losses(got, want):
    for k, rtol in DP_RTOL.items():
        if not math.isclose(got[k], want[k], rel_tol=rtol):
            raise AssertionError(f"step 1 {k}: ranks {got[k]}, one process "
                                 f"{want[k]}")


def _check_mu(got, want):
    """||got - want|| / ||want|| over every first-moment tensor, within
    DP_MU_REL."""
    num = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(got, want))
    den = sum(float((b.double() ** 2).sum()) for b in want)
    rel = math.sqrt(num / den)
    if rel > DP_MU_REL:
        raise AssertionError(f"step 1 first moment differs by {rel} "
                             f"relative (bound {DP_MU_REL})")
    return rel


def _check_params(cfg, out, i, got, want):
    """The largest param difference after step i + 1, within
    DP_PARAM_STEP_LRS (i + 1) lr; recorded into `out`."""
    diff = max(float((a.detach() - b).abs().max()) for a, b in zip(got, want))
    bound = DP_PARAM_STEP_LRS * (i + 1) * cfg.train.learning_rate
    out.setdefault("param_diff", []).append(diff)
    out.setdefault("param_bounds", []).append(bound)
    if diff > bound:
        raise AssertionError(f"params differ by {diff} after step {i + 1} "
                             f"(bound {bound})")


def _mp_ranks(torch, dev, rank):
    """(e) on this rank: point-parallel training at dp = 1 x mp = 2, the
    recipe and then the parity model, each against one process on the
    same batch (rank 0).  Returns {model: result}."""
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.parallel.collective_audit import all_reduce
    from wireframe_tpu_torch.parallel.mesh import Layout, local_rows
    from wireframe_tpu_torch.parallel.multihost import replicate_across_hosts
    from wireframe_tpu_torch.train.loop import device_batch, init_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.synth import (
        make_box_building_batch,
        targets_near_slots,
    )

    layout = Layout.of_group(mp=2)
    results = {}
    for name, config, sets, rows, kernels in (
            ("recipe", RECIPE, [], MP_RECIPE_ROWS, ("K2", "K3", "K4")),
            ("parity", PARITY, PARITY_SET, MP_PARITY_ROWS,
             ("K5 fwd", "K5 bwd", "K4"))):
        cfg = load_config(config, sets + [
            "train.lr_schedule=constant", "model.attn_dropout=0",
            "model.edge_dropout=0", f"train.batch_size={rows}",
            "parallel.mp=2"])
        model = init_model(cfg, dev, seed=SERVE_SEED)
        batch = targets_near_slots(cfg, model, make_box_building_batch(
            cfg, rows, seed=PARALLEL_SEED), PARALLEL_SEED, device=dev)
        n = cfg.data.num_points
        out = {"batch": f"{rows} x {n}", "slice": f"{rows} x {n // 2}",
               "ms": [], "ref_ms": []}
        whole = device_batch(batch, dev)
        if cfg.model.vertex_head == "query":
            # The KV tokens the encoder hands the decoder: gathered from
            # the two slices' K2 against one K2 call over the whole cloud.
            with torch.no_grad():
                kv = model.encoder(whole["point_clouds"], train=True,
                                   split=layout)[1]["kv"]
                if rank == 0:
                    ref_kv = model.encoder(whole["point_clouds"],
                                           train=True)[1]["kv"]
                    out["kv_equal"] = bool(torch.equal(kv, ref_kv))
                    out["kv_diff"] = float((kv - ref_kv).abs().max())
        if rank == 0:
            ref = create_train_state(cfg, init_model(cfg, dev,
                                                     seed=SERVE_SEED))
            ref_step = make_train_step(cfg)
            ref_gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
            ref_params = []
            for i in range(MP_STEPS):
                (_, m), t = _timed(torch, lambda: ref_step(ref, whole,
                                                           ref_gen))
                out["ref_ms"].append(round(t, 2))
                ref_params.append([p.detach().clone()
                                   for p in ref.model.parameters()])
                if i == 0:
                    out["ref_losses"] = {k: float(m[k]) for k in DP_RTOL}
                    ref_mu = [t.clone() for t in ref.mu.values()]
            del ref
        state = create_train_state(cfg, model)
        for tree in (state.model, state.mu, state.nu, state.ema_params):
            if tree is not None:
                replicate_across_hosts(tree)
        all_reduce(torch.zeros(1, device=dev))  # rank 0's reference done
        step = make_train_step(cfg, layout=layout)
        mine = device_batch(local_rows(batch, layout.dp_rank, layout.dp),
                            dev)
        gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
        reset_launches()
        for i in range(MP_STEPS):
            (_, m), t = _timed(torch, lambda: step(state, mine, gen))
            out["ms"].append(round(t, 2))
            if rank == 0:
                if i == 0:
                    out["losses"] = {k: float(m[k]) for k in DP_RTOL}
                    _check_losses(out["losses"], out["ref_losses"])
                    out["mu_rel"] = _check_mu(state.mu.values(), ref_mu)
                _check_params(cfg, out, i, state.model.parameters(),
                              ref_params[i])
        counts = launch_counts(MAIN_KEYS)
        out["launches"] = counts
        if any(counts[k] != MP_STEPS for k in kernels):
            raise AssertionError(f"{name} at mp=2: launches {counts}")
        if rank == 0 and "kv_equal" in out and not out["kv_equal"]:
            raise AssertionError(f"gathered KV differs from one process's "
                                 f"K2 by {out['kv_diff']}")
        results[name] = out
        del state, model
    return results


def rank_main(task: str) -> int:
    """One rank of the parallel phase (`task` "nccl" or "gloo"), started
    by `_run_ranks` with torchrun's environment; writes its result as
    JSON to $CHIP_SMOKE_OUT.  Exits 1 on any failure."""
    import torch
    import torch.distributed as dist

    try:
        out = {"nccl": _nccl_rank, "gloo": _gloo_rank}[task](torch)
        with open(os.environ["CHIP_SMOKE_OUT"], "w") as f:
            json.dump(out, f)
        return 0
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


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
    counts = launch_counts(MAIN_KEYS)
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

    none = dict.fromkeys(MAIN_KEYS, 0)

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
    totals, events, _, _ = trace_ops.aggregate_device_events(trace_dir)
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

    # The recipe forward in f32 through K1 f32 (at B=128 x 2560, 3 timed
    # iterations), counts to 0 just before and read just after.
    reset_launches()
    f32_env = {**BENCH_ENV, "BENCH_DTYPE": "float32", "BENCH_ITERS": "3",
               "BENCH_LAT_ITERS": "2", "BENCH_PARITY_SECONDARY": "0"}
    f32 = bench.run(f32_env, device=dev)
    torch.cuda.synchronize()
    counts = launch_counts(MAIN_KEYS + F32_KEYS)
    print(json.dumps(f32), flush=True)
    expected = {**{k: 0 for k in counts}, "K1 f32": f32["forward_calls"]}
    print(f"bench {f32_env}: recipe B={f32['batch']} x {f32['points']} in "
          f"f32 {f32['value']:.2f} clouds/s ({f32['mean_batch_ms']:.3f} ms a "
          f"batch, mfu against the bf16 peak {f32['mfu']:.4f}) beside bf16's "
          f"{fwd['value']:.2f} ({fwd['mean_batch_ms']:.3f} ms); launches "
          f"{counts}, expected {expected} [{card}]", flush=True)
    if counts != expected or f32["dtype"] != "float32":
        raise AssertionError(f"bench f32 launches {counts} != {expected}")
    launches["K1 f32"] = counts["K1 f32"]

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
                                  "lockstep_lsa", "layernorm_rows",
                                  "pair_mlp", "subm_conv",
                                  "neighbour_map", "knn", "gva"])
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

        phase = "pair MLP"
        pair = pair_mlp_phase(torch, dev, card, work)

        phase = "f32"
        f32 = f32_phase(torch, dev, card, work)

        phase = "limits"
        limits = limits_phase(torch, dev, card, work)

        from wireframe_tpu_torch.ops import subm_conv

        # The phases clear the launch registry as they go: the subm conv's
        # calls over both are counted on the op itself.
        with mock.patch.object(subm_conv, "subm_conv",
                               wraps=subm_conv.subm_conv) as conv:
            phase = "training"
            train_launches, _ = training_phase(torch, dev, card, work)

            phase = "parity training"
            parity_launches, _ = parity_phase(torch, dev, card, work)
        conv_trained = conv.call_count
        print(f"subm conv launches in the training and parity phases: "
              f"{conv_trained}", flush=True)
        if conv_trained:
            raise AssertionError("the recipe or parity model launched the "
                                 "subm conv kernel")

        phase = "ptv3"
        ptv3 = ptv3_phase(torch, dev, card, work)

        phase = "ptv2"
        ptv2 = ptv2_phase(torch, dev, card, work)

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

        phase = "parser"
        t0 = time.perf_counter()
        parser_phase(torch, dev, card, work)
        print(f"parser phase: {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)

        phase = "study"
        t0 = time.perf_counter()
        study_phase(torch, dev, card, work)
        print(f"study phase: {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)

        phase = "parallel"
        parallel = parallel_phase(torch, dev, card, work)

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
            "parallel_launches": parallel["K1"],
            "mp_launches_per_rank": [
                r["K1"] for r in parallel["mp_per_rank"]],
            "bench_launches": bench["K1"],
            "limits_launches": limits["a served"]["K1"]
            + limits["b served"]["K1"],
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
                            "parallel_launches": parallel[key],
                            "mp_launches_per_rank": [
                                r[key] for r in parallel["mp_per_rank"]],
                            "bench_launches": bench[key],
                            "limits_launches": sum(
                                limits[p].get(key, 0)
                                for p in ("a", "b", "c")),
                            **fields, "library_ms": None})
        # K4's variants (lockstep_lsa.k4_plan) on the limits paths, and its
        # new shapes alone.
        kernels[-1]["limits_variant_launches"] = {
            k[3:]: sum(limits[p].get(k, 0) for p in ("a", "b", "c"))
            for k in sorted({k for p in ("a", "b", "c") for k in limits[p]
                             if k.startswith("K4 ")})}
        kernels[-1]["limits_shapes"] = limits["K4"]
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
                            "parallel_launches": parallel[count],
                            "mp_launches_per_rank": [
                                r[count] for r in parallel["mp_per_rank"]],
                            "bench_launches": bench[count],
                            **k5[key], "library_ms": None})
        kernels[-1]["bench_backward"] = k5["bench backward"]
        # The f32 kernels: launches on the f32 phase's main paths ((a)
        # served and trained, (b) trained), the checkpoints' f32 K1 run
        # and the bench's f32 run.
        k1_f32 = {**f32["K1"][0][(3, 16384)], "max_abs_err": f32["K1"][1]}
        for key, name, fields, launched, source, replaces in (
                ("K1 f32", "fused_point_encoder (K1), float32", k1_f32,
                 f32["serve"]["K1 f32"], "fused_encoder.cu",
                 "pallas_encoder.py:71"),
                ("K2 f32", "chain forward, stash (K2), float32",
                 f32["chain"]["K2"], f32["recipe"]["K2 f32"],
                 "chain_grad.cu", "pallas_chain_grad.py:264"),
                ("K3 f32", "chain backward (K3), float32",
                 f32["chain"]["K3"], f32["recipe"]["K3 f32"],
                 "chain_grad.cu", "pallas_chain_grad.py:400"),
                ("K5 fwd f32", "chain forward, remat (K5), float32",
                 f32["chain"]["K5 forward"], f32["train"]["K5 fwd f32"],
                 "chain_grad.cu", "pallas_chain_grad.py:159"),
                ("K5 bwd f32", "chain backward, remat (K5), float32",
                 f32["chain"]["K5 backward"], f32["train"]["K5 bwd f32"],
                 "chain_grad.cu", "pallas_chain_grad.py:400")):
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"{src}{source} + {src}hopper_gemm.cuh",
                "replaces": f"wireframe_tpu/ops/{replaces}",
                "launches": launched,
                "checkpoints_launches": ckpts.get(key, 0),
                "bench_launches": bench.get(key, 0),
                "limits_launches": limits["c"].get(key, 0),
                **fields, "library_ms": None})
        # The split stages' LayerNorm row kernels: launches on the limits
        # paths ((b) served and trained in bf16, (c) trained in f32), times
        # at (8 x 2560, 4096) beside the whole split stage's.
        timing = limits["timing"]
        for key, name, part, launched, replaces in (
                ("LN rows fwd", "LayerNorm rows forward, split stage",
                 "forward", limits["b served"]["LN rows fwd"]
                 + limits["b"]["LN rows fwd"], "pallas_chain_grad.py:264"),
                ("LN rows bwd", "LayerNorm rows backward, split stage",
                 "backward", limits["b"]["LN rows bwd"],
                 "pallas_chain_grad.py:400"),
                ("LN rows fwd f32",
                 "LayerNorm rows forward, split stage, float32", "forward",
                 limits["c"]["LN rows fwd f32"], "pallas_chain_grad.py:159"),
                ("LN rows bwd f32",
                 "LayerNorm rows backward, split stage, float32", "backward",
                 limits["c"]["LN rows bwd f32"], "pallas_chain_grad.py:400")):
            tag = "f32" if key.endswith("f32") else "bf16"
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"{src}layernorm_rows.cu",
                "replaces": f"wireframe_tpu/ops/{replaces}",
                "launches": launched,
                **timing[tag][f"row kernel {part}"],
                "split_stage": timing[tag][f"split stage {part}"],
                "library_ms": None})
        kernels.append({
            "name": "pair MLP (edge head, inference)", "route": "cuda",
            "source": f"{src}pair_mlp.cu",
            "replaces": "none (eager tail of models/edge_head.py)",
            "launches": pair["served_launches"],
            "forwards": pair["served_forwards"],
            "train_launches": pair["train_launches"],
            "ptv3_launches": ptv3["pair_mlp_launches"],
            "ptv3_forwards": ptv3["forwards"],
            **{k: pair[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "pct_of_bound")},
            "max_abs_err": {k: pair[k]["kernel_vs_plain"]
                            for k in ("probs", "logits")},
            "library_ms": None})
        conv = ptv3["subm_conv"]
        kernels.append({
            "name": "submanifold conv (PTv3 stem and xCPE, inference)",
            "route": "cuda", "source": f"{src}subm_conv.cu",
            "replaces": "none (the JAX package has no PTv3)",
            "launches": conv["launches"], "forwards": conv["forwards"],
            "train_launches": conv_trained,
            "skipped_pct": conv["skipped_pct"],
            **{k: sum(r[k] for r in conv["rows"])
               for k in ("ms", "plain_ms", "bound_ms")},
            "shape": f"the {SUBM_CONVS} convolutions of a (128, 16384) call",
            "max_abs_err": max(r["kernel_vs_plain"] for r in conv["rows"]),
            "library_ms": None})
        nmap = ptv3["neighbour_map"][128]
        kernels.append({
            "name": "neighbour map (PTv3 levels)", "route": "cuda",
            "source": f"{src}neighbour_map.cu",
            "replaces": "none (the JAX package has no PTv3)",
            "launches": NEIGHBOUR_MAPS * ptv3["forwards"],
            "forwards": ptv3["forwards"],
            **{k: sum(r[k] for r in nmap)
               for k in ("ms", "plain_ms", "bound_ms")},
            "shape": f"the {NEIGHBOUR_MAPS} maps of a (128, 16384) call",
            "equal": all(r["equal"] for r in nmap), "library_ms": None})
        searches = ptv2["knn"][128]
        kernels.append({
            "name": "kNN search (PTv2 levels)", "route": "cuda",
            "source": f"{src}knn.cu",
            "replaces": "none (the JAX package has no PTv2)",
            "launches": KNN_SEARCHES * ptv2["forwards"],
            "forwards": ptv2["forwards"],
            **{k: sum(r[k] for r in searches)
               for k in ("ms", "plain_ms", "bound_ms")},
            "shape": f"the {KNN_SEARCHES} searches of a (128, 16384) call",
            "equal": all(r["equal"] for r in searches), "library_ms": None})
        gvas = ptv2["gva"][128]
        kernels.append({
            "name": "GVA (PTv2 blocks)", "route": "cuda",
            "source": f"{src}gva.cu",
            "replaces": "none (the JAX package has no PTv2)",
            "launches": GVA_CALLS * ptv2["forwards"],
            "forwards": ptv2["forwards"],
            **{k: sum(r[k] for r in gvas)
               for k in ("ms", "plain_ms", "bound_ms")},
            "shape": f"the {GVA_CALLS} GVAs of a (128, 16384) call",
            "max_gap": max(r["gap"] for r in gvas), "library_ms": None})
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
