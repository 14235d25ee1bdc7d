"""The split stages' LayerNorm row kernels (`ops.layernorm_rows`), the
CPU half.

The kernels (`csrc/layernorm_rows.cu`) run only on the card (`python3
chip_smoke.py`, phase "limits").  Here:

- `rows_plan`, which names what each call launches: every plan fits the
  227 KB a block may have, `part` keeps its (ceil(M / 128), 3 W) shape,
  the grid at (20480, 4096) fills the 132 SMs in more than one wave, and
  every width, ragged or past any row that stays resident, gets a mode;
- the wrappers' alignment check: a row stride that is not a multiple of
  16 bytes raises instead of taking another path;
- the order in which the kernels sum a row (each thread over its units
  in four chains, a warp by an xor butterfly, the block by a butterfly
  over the warps' sums, and chunks of a wide row merged by Chan's rule),
  emulated in float32 with numpy and held against `layernorm_relu_forward_plain` and the JAX
  `_ln` + ReLU, on rows with a mean of 1e3 and a spread of 1e-1 among
  them: the centred variance the kernels take keeps such rows, the raw
  moments E[z^2] - E[z]^2 do not.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.ops.pallas_encoder import _ln
from wireframe_tpu_torch.ops import layernorm_rows
from wireframe_tpu_torch.ops._launch import (
    SMEM_LIMIT,
    SMS,
    row_args,
    row_buffer,
)
from wireframe_tpu_torch.ops.layernorm_rows import (
    KERNEL,
    RESIDENT_MAX,
    ROW_TILE,
    layernorm_relu_backward,
    layernorm_relu_forward_plain,
    rows_plan,
    smem_bytes,
)

WIDTHS = (2049, 2304, 4096, 4100, 8192, 12288, 65536)
KINDS = (  # (compute dtype, direction, z dtype)
    (torch.bfloat16, "fwd", None),
    (torch.float32, "fwd", None),
    (torch.bfloat16, "bwd", torch.bfloat16),
    (torch.bfloat16, "bwd", torch.float32),
    (torch.float32, "bwd", torch.float32),
)
MODES = {"fwd": ("registers", "column chunks"),
         "bwd": ("shared memory", "column chunks")}


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[1]}-{k[0]}-{k[2]}")
@pytest.mark.parametrize("w", WIDTHS + (1, 7, 8193, 100003))
def test_every_plan_fits_a_block_s_shared_memory(w, kind):
    dtype, direction, zdt = kind
    for m in (1, 200, 20480):
        plan = rows_plan(m, w, dtype, direction, zdt)
        assert plan["smem_bytes"] <= SMEM_LIMIT
        zs = 2 if zdt == torch.bfloat16 else 4
        assert plan["smem_bytes"] == smem_bytes(
            direction, zs, plan["threads"], plan["ring"],
            plan["rows_per_cta"], w)
        assert 2 <= plan["ring"] <= layernorm_rows.MAX_RING
        assert plan["threads"] % 32 == 0
        assert plan["threads"] <= layernorm_rows.MAX_THREADS
        assert plan["chunk_cols"] == (layernorm_rows.VEC * plan["units"]
                                      * plan["threads"])
        assert plan["chunks"] * plan["chunk_cols"] >= w
        assert plan["ctas_per_sm"] >= 1


@pytest.mark.parametrize("m", [1, 127, 128, 129, 200, 20480])
@pytest.mark.parametrize("w", [2304, 4100, 65536])
def test_part_keeps_its_shape(m, w):
    """One partial row of d gamma | d beta | d b per 128-row tile, as the
    plain version (which the CPU wrapper takes) gives it; the backward's
    grid is one cluster a tile."""
    for dtype, zdt in ((torch.bfloat16, torch.bfloat16),
                       (torch.float32, torch.float32)):
        plan = rows_plan(m, w, dtype, "bwd", zdt)
        tiles = -(-m // ROW_TILE)
        assert plan["part"] == (tiles, 3 * w)
        assert plan["grid"] == tiles * plan["cluster"]
        assert plan["rows_per_cta"] * plan["cluster"] == ROW_TILE
    if m <= 200 and w <= 4100:
        z = torch.randn(m, w)
        _, _, part = layernorm_relu_backward(
            z, torch.randn(m, w), torch.ones(w), torch.zeros(w),
            dz_dtype=torch.float32, rebuild_h=False)
        assert tuple(part.shape) == (-(-m // ROW_TILE), 3 * w)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[1]}-{k[0]}-{k[2]}")
def test_the_grid_at_20480_by_4096_fills_the_card_in_waves(kind):
    dtype, direction, zdt = kind
    plan = rows_plan(20480, 4096, dtype, direction, zdt)
    assert plan["mode"] == MODES[direction][0]
    assert plan["grid"] >= 2 * SMS
    assert plan["waves"] > 1
    assert plan["waves"] == plan["grid"] / (SMS * plan["ctas_per_sm"])


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[1]}-{k[0]}-{k[2]}")
@pytest.mark.parametrize("w", WIDTHS)
def test_every_width_gets_a_mode(w, kind):
    dtype, direction, zdt = kind
    plan = rows_plan(20480, w, dtype, direction, zdt)
    resident, chunked = MODES[direction]
    if w <= RESIDENT_MAX:
        assert plan["mode"] == resident
        assert plan["chunks"] == 1
        # The smallest block that covers the row, a warp at a time.
        assert plan["chunk_cols"] - w < layernorm_rows.VEC * plan["units"] * 32
    else:
        assert plan["mode"] == chunked
        assert plan["chunks"] == math.ceil(w / plan["chunk_cols"]) > 1
        assert plan["threads"] == layernorm_rows.CHUNK_THREADS


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        rows_plan(0, 4096, torch.float32, "fwd")
    with pytest.raises(ValueError):
        rows_plan(10, 4096, torch.float16, "fwd")
    with pytest.raises(ValueError):
        rows_plan(10, 4096, torch.float32, "up")
    with pytest.raises(ValueError):  # f32 dz needs the f32 z
        rows_plan(10, 4096, torch.float32, "bwd", torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", [2049, 2304, 4100])
def test_unaligned_row_stride_raises(dtype, w):
    """The kernels move rows 16 bytes at a time: the wrappers' own
    buffers (rows a multiple of 8 elements apart) pass, a row stride
    that is not a multiple of 16 bytes or a start off 16 bytes raises."""
    good = row_buffer(3, w, dtype, torch.device("cpu"))
    assert row_args("z", good, KERNEL) == (good.data_ptr(), good.stride(0))
    assert row_args("h", None, KERNEL) == (None, 0)
    es = good.element_size()
    odd = torch.empty((3, w + 16 // es + 1), dtype=dtype)[:, :w]
    with pytest.raises(ValueError, match="16-byte"):
        row_args("z", odd, KERNEL)
    shifted = torch.empty((3, w + 16), dtype=dtype)[:, 1:w + 1]
    if shifted.data_ptr() % 16:
        with pytest.raises(ValueError, match="16-byte"):
            row_args("z", shifted, KERNEL)
    if w % (16 // es):
        with pytest.raises(ValueError, match="16-byte"):
            row_args("dh", torch.empty((3, w), dtype=dtype), KERNEL)


# ---------------------------------------------------------------------------
# The kernels' summation order, emulated in float32
# ---------------------------------------------------------------------------

F32 = np.float32


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the card contracts these)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def _butterfly(lanes):
    """(..., 32) -> (...): an xor butterfly over the last axis (offsets
    16, 8, 4, 2, 1; every lane ends with the same bits)."""
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    return lanes[..., 0]


def _block_sum(per_thread):
    """(rows, threads) partials -> (rows,): each warp by a butterfly, then
    one more butterfly over the warps' sums (lane w holding warp w's, 0
    past the last warp)."""
    rows, threads = per_thread.shape
    warps = _butterfly(per_thread.reshape(rows, threads // 32, 32))
    lanes = np.zeros((rows, 32), F32)
    lanes[:, :threads // 32] = warps
    return _butterfly(lanes)


def _lanes4(acc):
    """A thread's four chains joined as (0 + 1) + (2 + 3)."""
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def emulate_row_stats(z, plan, raw_moments=False):
    """(mean, rstd) of each row of z (rows, W) float32, summed as
    `csrc/layernorm_rows.cu` sums them under `plan`: thread t takes units
    t + T u (u < units) of 8 columns of each chunk and sums them in four
    chains (column e of a unit into chain e mod 4, unit by unit), joined
    as (0 + 1) + (2 + 3); the block as `_block_sum`; per chunk the mean
    (the sum times 1 / count), then the centred M2 about it (d * d + q
    contracted); chunks merged in order by Chan's rule.
    raw_moments: E[z^2] - E[z]^2 instead, the formula the kernels must
    not take."""
    rows, w = z.shape
    if raw_moments:
        mean = z.mean(-1, dtype=F32)
        var = np.maximum((z * z).mean(-1, dtype=F32) - mean * mean, F32(0))
        return mean, F32(1) / np.sqrt(var + F32(1e-6))
    threads, units, chunk = (plan["threads"], plan["units"],
                             plan["chunk_cols"])
    n = mean = m2 = None
    for k in range(plan["chunks"]):
        nk = min(chunk, w - k * chunk)
        x = np.zeros((rows, chunk), F32)
        x[:, :nk] = z[:, k * chunk:k * chunk + nk]
        valid = (np.arange(chunk) < nk).reshape(units, threads, 8)
        x = x.reshape(rows, units, threads, 8)
        acc = np.zeros((4, rows, threads), F32)
        for u in range(units):
            for e in range(8):
                acc[e % 4] = acc[e % 4] + x[:, u, :, e]
        fk = F32(nk)
        mk = _block_sum(_lanes4(acc)) * (F32(1) / fk)
        acc = np.zeros((4, rows, threads), F32)
        for u in range(units):
            for e in range(8):
                d = np.where(valid[u, :, e], x[:, u, :, e] - mk[:, None],
                             F32(0))
                acc[e % 4] = _fma(d, d, acc[e % 4])
        qk = _block_sum(_lanes4(acc))
        if k == 0:
            n, mean, m2 = fk, mk, qk
        else:
            nn = n + fk
            d = mk - mean
            mean = _fma(d, np.full_like(d, fk / nn), mean)
            m2 = m2 + (qk + d * d * F32(n * fk / nn))
            n = nn
    return mean, F32(1) / np.sqrt(m2 * (F32(1) / F32(w)) + F32(1e-6))


def _rows_with_large_means(w, seed):
    """Six rows: three N(0, 1), three of mean 1e3 and spread 1e-1; the
    LayerNorm terms near (1, 0)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(6, w)).astype(F32)
    z[3:] = (1e3 + 0.1 * rng.normal(size=(3, w))).astype(F32)
    g = (1 + 0.1 * rng.normal(size=w)).astype(F32)
    b = (0.1 * rng.normal(size=w)).astype(F32)
    return z, g, b


# Tolerances on h = relu(LayerNorm(z)) of unit scale.  On N(0, 1) rows
# the three float32 computations differ by summation order alone: within
# 1e-5 (read ~1e-6).  At a mean of 1e3 float32 spaces values 6.1e-5
# apart, 6.1e-4 of the spread of 0.1, and every sum of W such values
# rounds its mean by a few spacings: h within 5e-3 (read up to 1.1e-3
# against float64).  rstd within 1e-5 relative of float64 on every row.
H_ATOL = {"normal": 1e-5, "large mean": 5e-3}
RSTD_RTOL = 1e-5


@pytest.mark.parametrize("w", [2304, 4096, 65536])
def test_summation_order_matches_plain_and_jax(w):
    z, g, b = _rows_with_large_means(w, w)
    plan = rows_plan(6, w, torch.float32, "fwd")
    assert plan["mode"] == ("column chunks" if w > RESIDENT_MAX
                            else "registers")
    mean, rstd = emulate_row_stats(z, plan)
    h = np.maximum((z - mean[:, None]) * rstd[:, None] * g + b, F32(0))

    z64 = z.astype(np.float64)
    m64 = z64.mean(-1)
    r64 = 1.0 / np.sqrt(((z64 - m64[:, None]) ** 2).mean(-1) + 1e-6)
    np.testing.assert_allclose(rstd, r64, rtol=RSTD_RTOL)

    plain, _ = layernorm_relu_forward_plain(
        torch.from_numpy(z), torch.from_numpy(g), torch.from_numpy(b),
        h_dtype=torch.float32)
    jax_h = np.asarray(jnp.maximum(_ln(jnp.asarray(z), jnp.asarray(g),
                                       jnp.asarray(b)), 0.0))
    for want in (plain.numpy(), jax_h):
        np.testing.assert_allclose(h[:3], want[:3], rtol=0,
                                   atol=H_ATOL["normal"])
        np.testing.assert_allclose(h[3:], want[3:], rtol=0,
                                   atol=H_ATOL["large mean"])


@pytest.mark.parametrize("w", [2304, 4096, 65536])
def test_raw_moments_would_fail_the_large_mean_rows(w):
    """The same check with E[z^2] - E[z]^2: the N(0, 1) rows still pass,
    the rows of mean 1e3 miss by orders of magnitude, so the test above
    tells the two formulas apart."""
    z, g, b = _rows_with_large_means(w, w)
    plan = rows_plan(6, w, torch.float32, "fwd")
    mean, rstd = emulate_row_stats(z, plan, raw_moments=True)
    h = np.maximum((z - mean[:, None]) * rstd[:, None] * g + b, F32(0))
    plain, _ = layernorm_relu_forward_plain(
        torch.from_numpy(z), torch.from_numpy(g), torch.from_numpy(b),
        h_dtype=torch.float32)
    err = np.abs(h - plain.numpy())
    assert err[:3].max() <= H_ATOL["normal"]
    assert err[3:].max() > 100 * H_ATOL["large mean"]
