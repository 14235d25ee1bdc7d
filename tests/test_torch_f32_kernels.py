"""The encoder-chain kernels' two compute dtypes, on the host side.

K1 (`ops.fused_encoder`) and K2 / K3 / K5 (`ops.chain_grad`) compute on
the card in bfloat16 (the wgmma main loop of `csrc/hopper_gemm.cuh`) or
in float32 (its 3xTF32 wgmma main loop), the two dtypes the JAX kernels
take.
`kernel_dtype` is the one gate: every CUDA wrapper passes its
`compute_dtype` through it before it touches the card, so float16 raises
with one message everywhere.  `chain_plan` and `k1_plan` say, from the
shapes and the dtype alone, which main loop, tile and buffer dtypes a call
uses; the bf16 plans are the ones the kernels ran before f32 existed, and
the f32 plan (three ring stages beside two split tiles of B) fits the
same launch's shared memory.  The kernels themselves run
only on the card (`python3 chip_smoke.py`, phase "f32"); their plain
versions are held to the JAX kernels in f32 by tests/test_torch_
{chain_grad,encoder,train,parity}.py.
"""

import re

import numpy as np
import pytest
import torch

from wireframe_tpu_torch.ops import chain_grad, fused_encoder, hopper_gemm
from wireframe_tpu_torch.ops._launch import SMEM_LIMIT, launch_counts, pad8
from wireframe_tpu_torch.ops.hopper_gemm import (
    BK,
    BK_F32,
    BM,
    BN,
    F32_SPLIT,
    KS,
    STAGES,
    STAGES_F32,
    chain_plan,
    kernel_dtype,
    smem_bytes,
    split_k,
    split_tile_bytes,
)
from wireframe_tpu_torch.ops.fused_encoder import k1_plan

FULL = (512, 1024, 2048, 1024)
SHAPES = {
    # name: (rows B*N, input width, hidden widths, output width)
    "recipe (8, 2560)": (8 * 2560, 8, FULL, 512),
    "parity (3, 2560)": (3 * 2560, 8, FULL, 512),
    "bench (128, 2560)": (128 * 2560, 8, FULL, 512),
    "ragged cluster": (2 * 328, 8, (600, 1100), 300),
    "ragged": (2 * 200, 8, (40, 72), 36),
}
# The bf16 plans as the kernels took them before the f32 half existed:
# (row tiles, x_ld, stage_ld, out_ld, clusters, [(ksplit, slices) of each
# dW product]).
BF16_PLANS = {
    "recipe (8, 2560)": (160, 8, [512, 1024, 2048, 1024], 512, [2, 4, 8, 4],
                         [(512, 40), (2560, 8), (10240, 2), (10240, 2),
                          (2560, 8)]),
    "parity (3, 2560)": (60, 8, [512, 1024, 2048, 1024], 512, [2, 4, 8, 4],
                         [(512, 15), (960, 8), (3840, 2), (3840, 2),
                          (960, 8)]),
    "ragged cluster": (6, 8, [600, 1104], 304, [3, 5],
                       [(656, 1), (656, 1), (656, 1)]),
    "ragged": (4, 8, [40, 72], 40, [1, 1], [(400, 1), (400, 1), (400, 1)]),
}


def _cloud(b=2, n=64, d=8):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))


def _params(d=8, dims=(16, 32), c=24):
    rng = np.random.default_rng(1)
    prev, sp = d, []
    for h in dims:
        sp.append(tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            rng.normal(size=(prev, h)) / np.sqrt(prev),
            rng.normal(size=h) * 0.1, 1.0 + rng.normal(size=h) * 0.1,
            rng.normal(size=h) * 0.1)))
        prev = h
    fw = torch.from_numpy((rng.normal(size=(prev, c)) / np.sqrt(prev))
                          .astype(np.float32))
    return sp, fw, torch.zeros(c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_dtype_takes_bf16_and_f32(dtype):
    assert kernel_dtype(dtype) is dtype


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, "float32"])
def test_kernel_dtype_refuses_anything_else(dtype):
    with pytest.raises(ValueError, match="compute in bfloat16 or float32"):
        kernel_dtype(dtype)


def _call(entry, x, dtype):
    sp, fw, fb = _params()
    if entry == "K1":
        return fused_encoder._launch(x, sp, fw, fb, tile=32,
                                     return_point_features=False,
                                     compute_dtype=dtype, kv_pool=4)
    if entry == "K2 / K5 forward":
        return chain_grad._forward_cuda(x, sp, fw, fb, kv_pool=4,
                                        emit_features=True,
                                        compute_dtype=dtype)
    return chain_grad._backward_cuda(
        x, sp, fw, fb, None, g=torch.zeros(2, 64, 24), kv_pool=0,
        dpool=None, idx=None, dsums=None, compute_dtype=dtype, need_dx=True)


@pytest.mark.parametrize("entry", ["K1", "K2 / K5 forward",
                                   "K3 / K5 backward"])
def test_cuda_wrappers_check_the_dtype_first(entry):
    """float16 is refused by kernel_dtype before a wrapper reaches the
    card, so the message is the helper's on every entry point."""
    with pytest.raises(ValueError, match="compute in bfloat16 or float32"):
        _call(entry, _cloud(), torch.float16)


class _Reached(Exception):
    pass


@pytest.mark.parametrize("entry", ["K1", "K2 / K5 forward",
                                   "K3 / K5 backward"])
def test_cuda_wrappers_take_f32_to_the_kernel_library(entry, monkeypatch):
    """An f32 call passes the dtype gate and every argument check and
    goes on to load the kernel library (stubbed here: there is no card and
    no compiler), never to the plain version."""

    def reached():
        raise _Reached

    monkeypatch.setattr(chain_grad, "_lib", reached)
    monkeypatch.setattr(fused_encoder, "_lib", reached)
    counts = launch_counts()
    with pytest.raises(_Reached):
        _call(entry, _cloud(), torch.float32)
    assert launch_counts() == counts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_versions_and_count_nothing(dtype,
                                                               monkeypatch):
    """On the CPU every wrapper runs its plain version in either dtype,
    loads no kernel library and counts no launch, bf16 or f32."""
    from test_torch_chain_grad import no_kernel_library

    sp, fw, fb = _params()
    x = _cloud()
    no_kernel_library(monkeypatch)
    counts = launch_counts()
    got = fused_encoder.fused_point_encoder(x, sp, fw, fb, tile=32,
                                            compute_dtype=dtype, kv_pool=4)
    want = fused_encoder.fused_point_encoder_plain(
        x, sp, fw, fb, tile=32, compute_dtype=dtype, kv_pool=4)
    assert all(torch.equal(got[k], want[k]) for k in want)
    fwd = chain_grad.chain_forward(x, sp, fw, fb, kv_pool=4,
                                   compute_dtype=dtype)
    assert [z.dtype for z in fwd["zs"]] == [dtype] * 2
    chain_grad.remat_chain_backward(x, sp, fw, fb, g=fwd["features"],
                                    compute_dtype=dtype)
    assert launch_counts() == counts


@pytest.mark.parametrize("name", list(BF16_PLANS))
def test_bf16_plans_are_unchanged(name):
    m, d, widths, out = SHAPES[name]
    rows, x_ld, stage_ld, out_ld, clusters, slices = BF16_PLANS[name]
    for plan in (chain_plan(m, d, widths, out),
                 chain_plan(m, d, widths, out, torch.bfloat16)):
        assert (plan["row_tiles"], plan["x_ld"], plan["stage_ld"],
                plan["out_ld"], plan["clusters"]) == (
                    rows, x_ld, stage_ld, out_ld, clusters)
        assert [(s[0][1] - s[0][0], len(s)) for s in plan["dw_slices"]] \
            == slices
        assert plan["main_loop"] == "wgmma" and plan["tile"] == (BM, BN, BK)
        assert plan["stage_bytes"] == 48 * 1024
        assert (plan["stages"], plan["split_bytes"], plan["split"]) == (
            STAGES, 0, None)
        assert set(plan["dtypes"].values()) == {torch.bfloat16,
                                                torch.float32}
        assert plan["dtypes"]["recomputed_z"] == torch.float32


@pytest.mark.parametrize("name", list(SHAPES))
def test_f32_plan_runs_the_3xtf32_loop(name):
    m, d, widths, out = SHAPES[name]
    plan = chain_plan(m, d, widths, out, torch.float32)
    assert plan["main_loop"] == "3xtf32"
    assert plan["tile"] == (BM, BN, BK_F32) == (128, 256, 32)
    # A ring stage: 128 x 32 of A and 32 x 256 of B in f32 = 48 KB, the
    # bf16 stage's bytes, as TMA brings the operands; three of them, then
    # two split tiles of B (256 rows of 16 hi + 16 lo TF32 values, one
    # 128-byte swizzle row each): 144 + 64 KB, past the bf16 ring and
    # epilogue overlay, so the launch's shared memory grows to fit it.
    assert plan["stage_bytes"] == (128 * 32 + 32 * 256) * 4 == 48 * 1024
    assert plan["stages"] == STAGES_F32 == 3
    assert plan["split_bytes"] == 2 * split_tile_bytes() == 2 * 256 * 32 * 4
    assert STAGES_F32 * plan["stage_bytes"] + plan["split_bytes"] \
        == 208 * 1024
    assert plan["smem_bytes"] == smem_bytes() <= SMEM_LIMIT == 232448
    # Every form's A is split in registers; B, which TF32 wgmma reads only
    # K-major from shared memory, into a K-major split tile there, and
    # transposed where TMA brings it MN-major (W of z = h W, dz of
    # dW = h^T dz).  No operand is copied in device memory.
    assert plan["split"] == F32_SPLIT
    assert {f: s["A"][1] for f, s in plan["split"].items()} == {
        "FWD": "registers", "DH": "registers", "DW": "registers"}
    assert {f: s["B"] for f, s in plan["split"].items()} == {
        "FWD": ("MN-major", "shared, transposed"),
        "DH": ("K-major", "shared"),
        "DW": ("MN-major", "shared, transposed")}
    assert plan["split"]["DW"]["A"][0] == "MN-major"
    assert set(plan["dtypes"].values()) == {torch.float32}
    # 16-byte row strides for TMA, in f32 elements.
    for ld, width in [(plan["x_ld"], d), (plan["out_ld"], out)] + list(
            zip(plan["stage_ld"], widths)):
        assert (ld * 4) % 16 == 0 and width <= ld == pad8(width)
    dims = [d, *widths, out]
    for (i, h), slices in zip(zip(dims[:-1], dims[1:]), plan["dw_slices"]):
        assert slices == split_k(m, i, h, bk=BK_F32)
        assert slices[0][0] == 0 and slices[-1][1] == m
        ksplit = slices[0][1] - slices[0][0]
        assert ksplit % BK_F32 == 0 or len(slices) == 1


def test_plans_match_the_header_constants():
    """The tile, depth, stage count and shared memory the plan reckons
    with are csrc/hopper_gemm.cuh's (the kernels check them again on the
    card when the library loads)."""
    from wireframe_tpu_torch.ops import _build

    text = (_build.CSRC / "hopper_gemm.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}
    assert (const["BM"], const["BN"], const["BK"], const["BK_F32"],
            const["STAGES"], const["STAGES_F32"], const["KS"]) == (
                BM, BN, BK, BK_F32, STAGES, STAGES_F32, KS)
    assert const["MAX_CLUSTER"] == hopper_gemm.MAX_CLUSTER
    assert 2 * const["KS"] == const["BK_F32"]
    assert const["FLUSH_STAGES"] * const["BK_F32"] == \
        hopper_gemm.F32_FLUSH_K == 2048
    # 1024 to align + the f32 area (3 x 48 KB + 2 x 32 KB) + the cluster
    # exchange slots + the mbarriers.
    assert smem_bytes() == 1024 + 212992 + 2048 + 64 == 216128


@pytest.mark.parametrize("dtype, limit", [(torch.bfloat16, 0.35e9),
                                          (torch.float32, 0.70e9)])
def test_k1_peak_bytes_at_the_largest_bucket(dtype, limit):
    """K1 at (3, 16384) holds at most two consecutive activations (the
    two widest: 49152 x (1024 + 2048) elements) beside the validity, within
    the peak chip_smoke.py bounds it to."""
    plan = k1_plan(3, 16384, 8, FULL, 512, 4, dtype)
    esize = 4 if dtype == torch.float32 else 2
    assert plan["peak_bytes"] == 49152 * (1024 + 2048) * esize + 49152
    assert plan["peak_bytes"] <= limit
    assert plan["main_loop"] == ("3xtf32" if esize == 4 else "wgmma")
    assert plan["dtypes"]["h"] == dtype


@pytest.mark.parametrize("b, n, widths, out, p", [
    (3, 2048, FULL, 512, 4), (2, 200, (40, 72), 36, 5),
    (2, 328, (600, 1100), 300, 41)])
def test_k1_plan_windows_do_not_depend_on_the_dtype(b, n, widths, out, p):
    bf = k1_plan(b, n, 8, widths, out, p)
    f32 = k1_plan(b, n, 8, widths, out, p, torch.float32)
    same = ("tiles_per_cloud", "row_tiles", "tile_rows", "partials",
            "windows", "merges", "edges", "x_ld", "stage_ld", "clusters",
            "smem_bytes", "stage_bytes")
    assert {k: bf[k] for k in same} == {k: f32[k] for k in same}
    assert f32["tile"] == (128, 256, 32) and bf["tile"] == (128, 256, 64)
    assert f32["peak_bytes"] > bf["peak_bytes"]


def test_k1_plan_refuses_float16():
    with pytest.raises(ValueError, match="compute in bfloat16 or float32"):
        k1_plan(3, 2048, 8, FULL, 512, 4, torch.float16)
