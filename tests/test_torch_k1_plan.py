"""The host-side launch plan of K1, the fused point encoder.

`ops.fused_encoder.k1_plan` says what a K1 call on the card launches
(`csrc/fused_encoder.cu` on `csrc/hopper_gemm.cuh`): the projection's
128-row tiles run per cloud, so every row lies in exactly one tile of its
own cloud; each kv window is written whole by the one tile that holds it,
or, when it crosses a tile boundary, merged by the finalize kernel from
the edge partials of the tiles it touches; every stage is one LayerNorm
cluster of at most 8 CTAs of 256 columns.  The plan is pure, so it is
tested here on the CPU, and the kv_pool values the encoder routes to K1
(`models/encoder.py`) are shown to be taken.
"""

import pytest
import torch

from wireframe_tpu_torch.models import encoder as encoder_module
from wireframe_tpu_torch.models.encoder import PointNetEncoder
from wireframe_tpu_torch.ops.hopper_gemm import BM, ln_cluster
from wireframe_tpu_torch.ops.fused_encoder import k1_plan

FULL = (512, 1024, 2048, 1024)
SHAPES = {
    # name: (B, N, hidden widths, output width, kv_pool)
    "recipe bucket 2048": (3, 2048, FULL, 512, 4),
    "recipe bucket 16384": (3, 16384, FULL, 512, 4),
    "training shape": (64, 2560, FULL, 512, 4),
    "ragged": (2, 200, (40, 72), 36, 4),
    "ragged, no kv": (2, 200, (40, 72), 36, 0),
    "ragged, crossing windows": (2, 200, (40, 72), 36, 5),
    "one window a cloud": (2, 200, (40, 72), 36, 200),
    "windows over two tiles": (1, 768, (64,), 8, 384),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_every_row_lies_in_one_tile_of_its_own_cloud(name):
    b, n, widths, out, p = SHAPES[name]
    plan = k1_plan(b, n, 8, widths, out, p)
    assert plan["row_tiles"] == b * plan["tiles_per_cloud"]
    assert plan["partials"] == (b, plan["tiles_per_cloud"], 5, out)
    seen = torch.zeros(b * n, dtype=torch.int64)
    for cloud in range(b):
        for r0, r1 in plan["tile_rows"]:
            assert 0 <= r0 < r1 <= n and r1 - r0 <= BM
            seen[cloud * n + r0: cloud * n + r1] += 1
    assert bool((seen == 1).all())


def _window_parts(plan, p):
    """{window: [(tile, slot, rows of the window in that tile)]} of the
    edge partials, and {window: tiles that write it whole}."""
    whole, parts = {}, {}
    for t, ((r0, r1), (inside, slot0, slot1)) in enumerate(
            zip(plan["tile_rows"], plan["windows"])):
        for w in inside:
            assert r0 <= w * p and (w + 1) * p <= r1
            whole.setdefault(w, []).append(t)
        for slot, w in ((0, slot0), (1, slot1)):
            if w is not None:
                rows = range(max(r0, w * p), min(r1, (w + 1) * p))
                assert len(rows) > 0
                parts.setdefault(w, []).append((t, slot, rows))
    return whole, parts


@pytest.mark.parametrize("name", [k for k in SHAPES if SHAPES[k][4]])
def test_every_window_is_written_whole_once_or_merged(name):
    b, n, widths, out, p = SHAPES[name]
    plan = k1_plan(b, n, 8, widths, out, p)
    whole, parts = _window_parts(plan, p)
    merged = dict(plan["merges"])
    assert plan["edges"] == bool(merged)
    for w in range(n // p):
        if w in whole:
            assert len(whole[w]) == 1 and w not in parts and w not in merged
            continue
        # Merged: the finalize walk takes exactly the tiles' declared
        # partials, and those cover the window's rows once.
        assert sorted(merged[w]) == sorted((t, s) for t, s, _ in parts[w])
        rows = sorted(r for _, _, rs in parts[w] for r in rs)
        assert rows == list(range(w * p, (w + 1) * p))
    assert not set(merged) - set(range(n // p))


def test_windows_dividing_the_tile_need_no_edges():
    for p in (2, 4, 8, 16, 32, 64, 128):
        plan = k1_plan(3, 16384, 8, FULL, 512, p)
        assert not plan["edges"] and not plan["merges"]
    assert k1_plan(2, 200, 8, (40, 72), 36, 5)["edges"]


def _routed_kv_pool(monkeypatch, tile, n, p):
    """The kv_pool the encoder hands K1 for N = n at `tile`, read from the
    call itself (0: the encoder does not route p into the kernel)."""
    seen = {}

    def record(x, stage_params, final_w, final_b, **kw):
        seen.update(kw)
        c = final_w.shape[1]
        out = {k: torch.zeros(x.shape[0], c) for k in
               ("masked_mean", "masked_max", "mean", "max")}
        if kw["kv_pool"]:
            out["kv_features"] = torch.zeros(x.shape[0], n // kw["kv_pool"], c)
        return out

    monkeypatch.setattr(encoder_module, "fused_point_encoder", record)
    enc = PointNetEncoder(input_dim=8, hidden_dims=(8,), output_dim=8,
                          use_pallas=True, pallas_tile=tile, kv_pool=p)
    with torch.no_grad():
        enc(torch.ones(1, n, 8))
    assert seen["tile"] == tile
    return seen["kv_pool"]


@pytest.mark.parametrize("tile", [200, 256, 512])
def test_every_routed_kv_pool_is_taken(monkeypatch, tile):
    """Every p in 2..tile that the encoder routes into K1, at N = tile (a
    single tile a cloud) and N = 2 tiles, has a plan whose windows are all
    written; the windows that cross the kernel's 128-row tiles (p = 5, 25
    at tile 200; p = tile at N = tile) are merged from edge partials."""
    routed = 0
    for n in (tile, 2 * tile):
        for p in range(2, tile + 1):
            got = _routed_kv_pool(monkeypatch, tile, n, p)
            if not got:
                continue
            assert got == p
            routed += 1
            plan = k1_plan(1, n, 8, (8,), 8, p)
            whole, _ = _window_parts(plan, p)
            merged = dict(plan["merges"])
            for w in range(n // p):
                assert (w in whole) != (w in merged)
    assert routed > 0


@pytest.mark.parametrize("widths", [(512, 4096), (4096,), (2049, 8)])
def test_a_stage_wider_than_a_cluster_is_refused(widths):
    """A stage wider than 8 x 256 columns is refused a cluster and runs
    split (its f32 z in device memory, then the LayerNorm row kernel), so
    the plan takes it; narrower stages keep their clusters."""
    plan = k1_plan(3, 2048, 8, widths, 512, 4)
    for w, mode, ctas in zip(widths, plan["modes"], plan["clusters"]):
        if w > 2048:
            assert mode == "split" and ctas is None
            with pytest.raises(ValueError, match="cluster"):
                ln_cluster(w)
        else:
            assert mode == ("cluster", ctas) == ("cluster", -(-w // 256))


def test_strides_and_clusters():
    plan = k1_plan(3, 16384, 8, FULL, 512, 4)
    assert plan["clusters"] == [2, 4, 8, 4]
    assert plan["x_ld"] == 8 and plan["stage_ld"] == list(FULL)
    assert plan["tiles_per_cloud"] == 128
    ragged = k1_plan(2, 200, 3, (40, 72), 36, 4)
    assert ragged["x_ld"] == 8 and ragged["stage_ld"] == [40, 72]
    assert ragged["clusters"] == [1, 1] and ragged["tile_rows"] == [
        (0, 128), (128, 200)]
    with pytest.raises(ValueError, match="multiple"):
        k1_plan(2, 200, 8, (40,), 36, 3)
