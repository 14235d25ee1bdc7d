"""The host-side launch plan of the chain kernels K2 / K3 / K5.

`ops.hopper_gemm.chain_plan` turns the chain's shapes into what the CUDA
wrappers launch with (`csrc/hopper_gemm.cuh`): one cluster of
ceil(W / 256) CTAs per fused LayerNorm stage, within the portable limit of
8; row strides padded to multiples of 8 elements, as TMA's 16-byte rows
need; and the K-slices of every split dW = h^T dz product, which must
cover every row once, in order, on whole 64-row K-tiles.  It is pure, so
it is tested here on the CPU at the recipe's widths and at ragged ones.
"""

import pytest
import torch

from wireframe_tpu_torch.ops._launch import pad8, row_buffer, tma_rows
from wireframe_tpu_torch.ops.hopper_gemm import (
    BK,
    BN,
    MAX_CLUSTER,
    chain_plan,
    ln_cluster,
    split_k,
    stage_mode,
)

SHAPES = {
    # name: (rows B*N, input width, hidden widths, output width)
    "recipe (8, 2560)": (8 * 2560, 8, (512, 1024, 2048, 1024), 512),
    "parity (3, 2560)": (3 * 2560, 8, (512, 1024, 2048, 1024), 512),
    "ragged cluster": (2 * 328, 8, (600, 1100), 300),
    "ragged": (2 * 200, 8, (40, 72), 36),
    "odd input": (129, 3, (2048, 7), 1),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_one_cluster_per_stage_within_the_portable_limit(name):
    m, d, widths, out = SHAPES[name]
    plan = chain_plan(m, d, widths, out)
    assert plan["clusters"] == [-(-w // BN) for w in widths]
    assert all(1 <= cs <= MAX_CLUSTER for cs in plan["clusters"])
    assert plan["row_tiles"] == -(-m // 128)


@pytest.mark.parametrize("width", [0, MAX_CLUSTER * BN + 1, 4096])
def test_a_stage_wider_than_a_cluster_is_refused(width):
    """No cluster takes a stage of width 0 or wider than 8 x 256 columns.
    Width 0 is no stage at all; a wider stage runs split instead (the GEMM
    writes its f32 product, the LayerNorm row kernels normalize it)."""
    with pytest.raises(ValueError, match="cluster"):
        ln_cluster(width)
    if width == 0:
        with pytest.raises(ValueError, match="width >= 1"):
            stage_mode(width)
        return
    plan = chain_plan(2 * 64, 8, (512, width), 300)
    assert stage_mode(width) == "split"
    assert plan["modes"] == [("cluster", 2), "split"]
    assert plan["clusters"] == [2, None]
    assert plan["stage_ld"] == [512, pad8(width)]


@pytest.mark.parametrize("name", list(SHAPES))
def test_padded_strides_are_multiples_of_8(name):
    m, d, widths, out = SHAPES[name]
    plan = chain_plan(m, d, widths, out)
    pairs = [(plan["x_ld"], d), (plan["out_ld"], out)] + list(
        zip(plan["stage_ld"], widths))
    for ld, width in pairs:
        assert ld % 8 == 0 and width <= ld < width + 8


@pytest.mark.parametrize("name", list(SHAPES))
def test_split_k_slices_cover_every_row_in_order(name):
    m, d, widths, out = SHAPES[name]
    dims = [d, *widths, out]
    plan = chain_plan(m, d, widths, out)
    assert len(plan["dw_slices"]) == len(dims) - 1
    for (i, h), slices in zip(zip(dims[:-1], dims[1:]), plan["dw_slices"]):
        assert slices == split_k(m, i, h)
        assert slices[0][0] == 0 and slices[-1][1] == m
        for (a, b), (c, _) in zip(slices, slices[1:]):
            assert b == c                      # contiguous, in order
        ksplit = slices[0][1] - slices[0][0]
        assert ksplit % BK == 0 or len(slices) == 1
        assert all(b - a == ksplit for a, b in slices[:-1])
        assert all(0 < b - a <= ksplit for a, b in slices)
        tiles = -(-i // 128) * -(-h // BN)
        assert len(slices) == 1 or len(slices) * tiles <= 132


def test_split_k_fills_the_card_at_the_recipe_shape():
    m = 8 * 2560
    assert len(split_k(m, 8, 512)) == 40      # 2 tiles: 512-row slices
    assert len(split_k(m, 512, 1024)) == 8    # 16 tiles
    assert len(split_k(m, 1024, 2048)) == 2   # 64 tiles
    assert split_k(100, 2048, 2048) == [(0, 100)]


@pytest.mark.parametrize("width", [8, 36, 300, 1100])
def test_row_buffers_and_tma_copies(width):
    buf = row_buffer(5, width, torch.bfloat16, torch.device("cpu"))
    assert buf.shape == (5, width) and buf.stride(0) == pad8(width)
    src = torch.arange(5 * width, dtype=torch.float32).reshape(5, width)
    got = tma_rows(src, torch.bfloat16)
    assert got.stride(0) % 8 == 0 and got.data_ptr() % 16 == 0
    assert torch.equal(got, src.to(torch.bfloat16))
    # Already aligned: no copy.
    assert tma_rows(buf, torch.bfloat16).data_ptr() == buf.data_ptr()
