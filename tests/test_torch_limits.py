"""Every shape the JAX kernels take, on the port's side (the CPU half).

The JAX kernels assert only R <= C for K4 (`pallas_lsa.py:214`) and
their tiling for K1, K2, K3 and K5.  On the card the port takes the same
shapes: K4 runs one warp per sample up to C = 512 and a block of warps
beyond, with its costs in shared memory while they fit and in device
memory otherwise (`lockstep_lsa.k4_plan`); a chain stage wider than one
cluster of 8 x 256 columns runs split, its GEMM writing the f32 product
and the LayerNorm row kernels of `ops.layernorm_rows` doing the rest
(`hopper_gemm.stage_mode`).  Those kernels run only on the card
(`python3 chip_smoke.py`, phase "limits"); here, on the CPU:

- K4's plain version (its oracle on the card) is array_equal to the JAX
  package's lockstep solver past 128 columns: random costs, forced ties,
  partial rows, a clamped NaN row, and to the Pallas kernel in interpret
  mode; and `k4_plan` takes every R <= C, keeping today's variant for
  C <= 128;
- `chain_plan` / `k1_plan` name the split stages, their strides and the
  f32 buffer a split stage adds to K1's peak memory;
- the plain chain (the oracle of K2, K3 and K5) at a 2304-wide stage
  against `make_differentiable_chain` (interpret mode) at (1, 64) rows,
  with tests/test_torch_chain_grad.py's tolerances, and the row kernels'
  plain versions against the plain chain's own stage arithmetic;
- the first train step of the recipe at max_vertices=136 (a 136 x 136
  assignment per sample) against the JAX step, as tests/test_torch_train.py
  holds its steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment
from test_torch_chain_grad import TOL, _run_jax, _run_torch
from test_torch_train import RECIPE, SMALL, _three_steps_match

from wireframe_tpu.ops.pallas_lsa import (
    max_safe_cost,
    solve_lsa_rows_lockstep,
    solve_lsa_rows_pallas,
)
from wireframe_tpu_torch.ops import layernorm_rows
from wireframe_tpu_torch.ops._launch import SMEM_LIMIT, launch_counts, pad8
from wireframe_tpu_torch.ops.chain_grad import (
    _stage_stats,
    chain_backward_plain,
    chain_forward_plain,
)
from wireframe_tpu_torch.ops.fused_encoder import k1_plan
from wireframe_tpu_torch.ops.hopper_gemm import (
    BN,
    MAX_CLUSTER,
    chain_plan,
    stage_mode,
)
from wireframe_tpu_torch.ops.lockstep_lsa import (
    k4_plan,
    solve_lsa_rows,
    solve_lsa_rows_lockstep_plain,
)


def _costs(kind, shape, seed):
    b, r, c = shape
    rng = np.random.default_rng(seed)
    if kind == "ties":
        cost = (rng.integers(0, 4, size=shape) * 0.5).astype(np.float32)
    else:
        cost = (rng.random(shape) * 10).astype(np.float32)
    nr = np.full(b, r, np.int32)
    if kind == "partial_rows":
        nr = rng.integers(0, r + 1, size=b).astype(np.int32)
        nr[:2] = (0, r)
    if kind == "nan_clamped":
        cost[0, 2, :] = np.nan
        cost[0, 0, 3] = 1e12
        ceil = max_safe_cost()
        cost = np.where(np.isnan(cost), ceil,
                        np.minimum(cost, ceil)).astype(np.float32)
    return cost, nr


@pytest.mark.parametrize("kind,shape,seed", [
    ("random", (2, 136, 160), 0),
    ("ties", (2, 24, 256), 1),
    ("partial_rows", (3, 40, 200), 2),
    ("nan_clamped", (1, 12, 200), 3),
])
def test_k4_plain_equals_jax_lockstep_past_128_columns(kind, shape, seed):
    cost, nr = _costs(kind, shape, seed)
    want = np.asarray(solve_lsa_rows_lockstep(jnp.asarray(cost),
                                              jnp.asarray(nr)))
    got = solve_lsa_rows(torch.from_numpy(cost), torch.from_numpy(nr))
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "nan_clamped":
        return
    for i, k in enumerate(nr):
        if k == 0:
            assert (got[i] == -1).all()
            continue
        g = got[i, :k].numpy()
        assert len(set(g.tolist())) == k
        rows, cols = linear_sum_assignment(cost[i, :k])
        np.testing.assert_allclose(cost[i, np.arange(k), g].sum(),
                                   cost[i, rows, cols].sum(), rtol=1e-5)


def test_k4_plain_equals_pallas_interpret_past_128_columns():
    cost, nr = _costs("random", (1, 10, 136), 4)
    want = np.asarray(solve_lsa_rows_pallas(jnp.asarray(cost),
                                            jnp.asarray(nr), interpret=True))
    got = solve_lsa_rows_lockstep_plain(torch.from_numpy(cost),
                                        torch.from_numpy(nr))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [40, 64, 128, 129, 256, 512, 513, 2048])
def test_k4_plan_takes_every_r_up_to_c(c):
    for r in sorted({0, 1, c // 2, c}):
        plan = k4_plan(r, c)
        assert plan["smem_bytes"] <= SMEM_LIMIT
        assert plan["threads"] * plan["cols_per_thread"] >= c
        if c <= 512:
            assert plan["variant"] == "warp" and plan["threads"] == 32
            assert plan["state"] == "registers"
        else:
            assert plan["variant"] == "block"
            assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
        if plan["costs"] == "shared":
            assert plan["smem_bytes"] >= r * c * 4
        if c <= 128:
            # Today's kernel: one warp, 2 (C <= 64) or 4 columns a lane,
            # the costs in shared memory.
            assert (plan["variant"], plan["cols_per_thread"],
                    plan["costs"]) == ("warp", 2 if c <= 64 else 4,
                                       "shared")
    with pytest.raises(ValueError, match="rows <= cols"):
        k4_plan(c + 1, c)


@pytest.mark.parametrize("r,c,costs,state", [
    (238, 238, "shared", "registers"),    # the last square that fits
    (239, 239, "global", "registers"),
    (40, 512, "shared", "registers"),
    (300, 512, "global", "registers"),
    (64, 513, "shared", "shared"),
    (64, 1024, "global", "shared"),
    (16, 13000, "global", "shared"),
    (32, 16384, "global", "global"),      # the state leaves shared memory
    (5, 100000, "global", "global"),
])
def test_k4_plan_across_the_shared_memory_edge(r, c, costs, state):
    plan = k4_plan(r, c)
    assert (plan["costs"], plan["state"]) == (costs, state)
    assert (plan["scratch_bytes"] > 0) == (state == "global")
    assert plan["name"].startswith(plan["variant"])


WIDE = {
    # name: (rows, hidden widths, output width, split stages)
    "recipe with a 4096 stage": (8 * 2560, (512, 1024, 4096, 1024), 512,
                                 [False, False, True, False]),
    "one stage of 2304": (2 * 328, (2304,), 2304, [True]),
    "one stage of 8192": (2 * 328, (8192,), 2304, [True]),
}


@pytest.mark.parametrize("name", list(WIDE))
def test_chain_plan_names_the_split_stages(name):
    m, widths, out, split = WIDE[name]
    plan = chain_plan(m, 8, widths, out)
    for w, mode, ctas, is_split in zip(widths, plan["modes"],
                                       plan["clusters"], split):
        assert stage_mode(w) == mode
        if is_split:
            assert w > MAX_CLUSTER * BN and mode == "split" and ctas is None
        else:
            assert mode == ("cluster", -(-w // BN)) and ctas == mode[1]
    assert plan["stage_ld"] == [pad8(w) for w in widths]
    assert plan["out_ld"] == pad8(out)
    assert len(plan["dw_slices"]) == len(widths) + 1


@pytest.mark.parametrize("name", list(WIDE))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_plan_counts_the_split_stage_z(name, dtype):
    """K1's peak holds, beside two consecutive activations, the f32 z of
    the split stage between them; in f32 after a stage wider than 2048 the
    projection's outputs include the f32 features, where the 3xTF32 main
    loop parks its partial sums."""
    m, widths, out, split = WIDE[name]
    b, n = (8, 2560) if m == 8 * 2560 else (2, 328)
    plan = k1_plan(b, n, 8, widths, out, 4, dtype)
    esize = 2 if dtype == torch.bfloat16 else 4
    acts = [m * pad8(w) * esize for w in (8, *widths)]
    z = [m * pad8(w) * 4 if s else 0 for w, s in zip(widths, split)]
    pairs = [x + y + zz for x, y, zz in zip(acts, acts[1:], z)]
    tiles = -(-n // 128)
    outs = 4 * (b * (n // 4) * out + b * tiles * 5 * out + b * 4 * out)
    if dtype == torch.float32 and widths[-1] > 2048:
        outs += 4 * m * out
    assert plan["modes"] == chain_plan(m, 8, widths, out, dtype)["modes"]
    assert not plan["merges"]
    assert plan["peak_bytes"] == m + max(pairs + [acts[-1] + outs])
    if name == "recipe with a 4096 stage":
        # The 4096 stage's f32 z (335 MB) beside the h on either side.
        assert plan["peak_bytes"] == m + pairs[2]


def _wide_cloud(seed, n=64, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, n, d)).astype(np.float32)
    x[0, 40:] = 0.0            # padding tail
    x[0, 17] = x[0, 16]        # duplicated rows: exact ties in a window
    return x


def _wide_params(seed, d=8, width=2304, c=24):
    rng = np.random.default_rng(seed)
    sp = [tuple(a.astype(np.float32) for a in (
        rng.normal(size=(d, width)) / np.sqrt(d), rng.normal(size=width) * 0.1,
        1.0 + rng.normal(size=width) * 0.1, rng.normal(size=width) * 0.1))]
    fw = (rng.normal(size=(width, c)) / np.sqrt(width)).astype(np.float32)
    fb = (rng.normal(size=c) * 0.1).astype(np.float32)
    return sp, fw, fb


@pytest.mark.parametrize("backward", ["stash", "remat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_chain_at_a_2304_stage_matches_jax(backward, dtype):
    sp, fw, fb = _wide_params(1)
    x = _wide_cloud(2)
    assert stage_mode(sp[0][0].shape[1]) == "split"
    want_o, want_g = _run_jax(x, sp, fw, fb, 4, True, dtype, backward)
    got_o, got_g = _run_torch(x, sp, fw, fb, 4, True, dtype, backward)
    # The JAX tests' tolerances (TOL).  The tighter bound the small-width
    # test holds the bf16 remat chain to does not carry over: over 18432
    # weights of the wide stage a few dz roundings to bf16 flip (2 of them
    # land 1.7e-3 apart, 1e-2 relative).
    tol = TOL[dtype]
    for g, w in zip(got_o, want_o):
        np.testing.assert_allclose(g, w, **tol["fwd"])
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, err_msg=f"gradient {i}",
                                   **tol["grad"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("remat", [False, True])
def test_row_kernels_plain_versions_are_the_chain_s_stage(dtype, remat):
    """The split stage's row kernels are held on the card to these plain
    versions: here they give the plain chain's own h, stash, dz, rebuilt
    h and (summed over the 128-row tiles in order) d gamma, d beta, d b,
    at 200 rows (a ragged last tile) of a 2304-wide stage."""
    sp, fw, fb = _wide_params(3, c=40)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 100, 8)).astype(np.float32))
    stages = [tuple(torch.from_numpy(a) for a in sp[0])]
    fwt, fbt = torch.from_numpy(fw), torch.from_numpy(fb)
    w, b, g, be = stages[0]
    z32 = (x.reshape(200, 8).to(dtype).float() @ w.to(dtype).float()) + b
    res = chain_forward_plain(x, stages, fwt, fbt, compute_dtype=dtype)
    h, stash = layernorm_rows.layernorm_relu_forward(
        z32, g, be, h_dtype=dtype,
        stash_dtype=dtype if dtype == torch.bfloat16 else None)
    assert torch.equal(h, _stage_stats(z32, g, be, dtype)[0])
    if stash is not None:
        assert torch.equal(stash, res["zs"][0].reshape(200, -1))
    gcot = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 100, 40)).astype(np.float32))
    _, (dst,), _, _ = chain_backward_plain(
        x, stages, fwt, fbt, None if remat else res["zs"], g=gcot,
        compute_dtype=dtype)
    z = z32 if remat else res["zs"][0].reshape(200, -1)
    dh = (gcot.reshape(200, 40).to(dtype).float()
          @ fwt.t().to(dtype).float())
    dz, hout, part = layernorm_rows.layernorm_relu_backward(
        z, dh, g, be, dz_dtype=dtype, rebuild_h=not remat)
    assert part.shape == (2, 3 * 2304)
    sums = part.sum(0)
    for got, want in zip((sums[:2304], sums[2304:4608], sums[4608:]),
                         (dst[2], dst[3], dst[1])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert (hout is None) == remat
    if hout is not None:
        assert torch.equal(hout, _stage_stats(z.float(), g, be, dtype)[0])
    assert dz.dtype == dtype
    # dW = h^T dz is the chain's first-stage weight gradient.
    dw = x.reshape(200, 8).to(dtype).float().t() @ dz.float()
    np.testing.assert_allclose(dw.numpy(), dst[0].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_row_kernel_wrappers_take_plain_on_cpu_and_count_nothing(
        monkeypatch):
    from test_torch_chain_grad import no_kernel_library

    z = torch.randn(5, 2400)
    g, be = torch.ones(2400), torch.zeros(2400)
    no_kernel_library(monkeypatch)
    counts = launch_counts()
    layernorm_rows.layernorm_relu_forward(z, g, be, h_dtype=torch.float32)
    layernorm_rows.layernorm_relu_backward(z, z, g, be,
                                           dz_dtype=torch.float32,
                                           rebuild_h=True)
    assert launch_counts() == counts


def test_first_step_at_136_vertices_matches_make_train_step():
    """The recipe at small width with max_vertices=136: the loss solves a
    (2, 136, 136) assignment, past the 128 columns the card's kernel once
    took.  One step against the JAX step from the same weights: every
    metric (losses, matching RMSE, grad_norm), then the params, EMA and
    Adam moments, as tests/test_torch_train.py holds its three steps.
    Later steps are not compared here: after Adam's first update (every
    weight moved by +-lr, so a gradient within float noise of 0 moves its
    weight 2 lr apart) 136 targets among 136 crowded slots swap partners
    on float noise alone; the port's own step-3 grad_norm moves 1.5e-4
    and its hungarian_rmse 2e-3 relative with nothing but the CPU's
    thread count changed."""
    overrides = [o for o in SMALL if not o.startswith("data.max_vertices")]
    _three_steps_match(RECIPE, overrides + ["data.max_vertices=136",
                                            "train.lr_schedule=constant"],
                       steps=1)
