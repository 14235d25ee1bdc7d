"""The port's Point Transformer V2 encoder (`model.encoder: ptv2`) on the
CPU at small widths (clouds of 20-600 points), against the benchmark's
plain reference (`port_bench/reference/ptv2.py`):

- the kNN search's plain version against the reference's per-cloud
  search: the sets equal, -1 past a cloud of fewer than k rows, ties
  kept in row order; the wrapper's CPU route and refusals; the kernel's
  block scheme (`csrc/knn.cu`: spans of clouds staged in chunks, the K
  best kept by one compare-and-swap pass) transcribed, against the plain
  search (the kernel itself runs on the card: `chip_smoke.py`'s ptv2
  phase);
- level 0 (grid sampling) and grid pooling on continuous coordinates
  against the reference's per-cloud rows, cells and cell means, equal;
- one block (its grouped vector attention) against the reference on a
  level with clouds of fewer than k rows;
- the whole forward against the reference on seeded weights: float32
  within 1e-5 (the two differ in summation order and in BatchNorm folded
  to a scale and a shift: ~2e-7 seen), bfloat16 within 0.01 (operands
  rounded to bf16 at every product, the packed and the per-cloud products
  round apart: ~0.002 seen), a bound the planted fault (the positional
  bias of encoder stage 0's first block left out) exceeds;
- the GVA kernel's wrapper (`ops/gva.py`): its route, the model's rule
  (`engages`) and counters, its refusals, and its blocking
  (`csrc/gva.cu`) transcribed against `gva_plain` (the kernel itself runs
  on the card: `chip_smoke.py`'s ptv2 phase);
- a capacity overflow raises `CapacityOverflow` where the outputs are
  read (serving, evaluation), and the next call that fits is served;
- `make_train_step` refuses the configuration; the reference imports
  nothing of the port and no JAX; the config keys; the cell's per-layer
  readers (the GVA kernel's roofline among them) and operation counts,
  and the cell's driver on the CPU at a cut size.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import corpus
from port_bench.drivers.infer_ptv3 import ptv3_weights
from port_bench.reference import ptv2 as R
from port_bench.reference.model import Precision
from wireframe_tpu_torch.config import config_to_dict, load_config
from wireframe_tpu_torch.models.ptv2 import PTv2Backbone
from wireframe_tpu_torch.models.ptv3 import (
    OVERFLOW,
    CapacityOverflow,
    capacity_rows,
    raise_on_overflow,
)
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.ops import knn as knn_op
from wireframe_tpu_torch.ops import voxel
from wireframe_tpu_torch.train.step import make_forward_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
CELL = "ptv2-infer-b128-16k"
H100 = "NVIDIA H100 80GB HBM3"
SMALL = ["model.encoder=ptv2", "model.ptv2_patch_embed_channels=12",
         "model.ptv2_patch_embed_groups=3",
         "model.ptv2_enc_channels=12,24,24,32",
         "model.ptv2_enc_groups=3,6,6,8",
         "model.ptv2_dec_channels=12,12,24,24",
         "model.ptv2_dec_groups=3,3,6,6", "model.decoder_dim=32",
         "model.decoder_layers=2", "model.decoder_heads=4",
         "model.decoder_ffn_dim=64", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.encoder_output_dim=32",
         "model.ptv2_grid_size=0.05",
         "model.ptv2_grid_sizes=0.15,0.3,0.6,1.2",
         "model.ptv2_capacity=1,1,1,1,1", "data.num_points=640",
         "data.max_vertices=16"]
SIZES = (128, 300, 600, 450)


def _cfg(dtype="float32", extra=()):
    return load_config(RECIPE, SMALL + [f"model.compute_dtype={dtype}",
                                        *extra])


def _clouds(seed=1, sizes=SIZES, n=640):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(sizes), n, 8), np.float32)
    for i, k in enumerate(sizes):
        raw, _, _ = corpus.make_building(rng, n_points=k)
        pc, _, _, _ = corpus.normalize(corpus.select_features(raw))
        x[i, :k] = corpus.z_sort_rows(pc)
    return torch.from_numpy(x)


def _model(cfg, seed=3):
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  PointCloudToWireframe(cfg.model).state_dict().items()}
    w = ptv3_weights(shapes, seed, "cpu")
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(w, strict=True)
    return model.eval(), w


def _packed(clouds, pad):
    """(xyz, batch, offsets) of clouds packed one after another, then
    `pad` dummy rows."""
    xyz = torch.cat(list(clouds) + [torch.zeros(pad, 3)])
    counts = torch.tensor([len(c) for c in clouds], dtype=torch.long)
    batch = torch.cat([torch.full((len(c),), i, dtype=torch.long)
                       for i, c in enumerate(clouds)]
                      + [torch.full((pad,), len(clouds), dtype=torch.long)])
    return xyz, batch, voxel.cloud_offsets(counts)


def _random_clouds(seed, sizes=(5, 40, 1, 23, 16)):
    """Clouds with repeated points and points on a lattice, so distances
    tie."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for n in sizes:
        c = torch.randint(0, 4, (n, 3), generator=gen).float() * 0.25
        c[::3] += torch.rand((len(c[::3]), 3), generator=gen)
        out.append(c)
    return out


# --- the kNN search ------------------------------------------------------

@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_knn_equals_the_reference(seed, k):
    clouds = _random_clouds(seed)
    xyz, batch, offsets = _packed(clouds, 6)
    got = knn_op.knn(xyz, batch, offsets, k)
    assert got.shape == (len(xyz), k) and got.dtype == torch.int64
    start = 0
    for c in clouds:
        n = len(c)
        local = torch.where(got[start:start + n] >= 0,
                            got[start:start + n] - start,
                            torch.full_like(got[start:start + n], -1))
        assert torch.equal(local, R.knn(c, k))
        # -1 exactly past the cloud's rows; the row itself first or tied.
        assert bool(((local >= 0).sum(1) == min(n, k)).all())
        start += n
    assert bool((got[start:] == -1).all())


def test_knn_ties_keep_row_order():
    # Four corners of a square around the query: all at one distance.
    c = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0],
                      [1.0, -1.0, 0.0], [-1.0, -1.0, 0.0], [3.0, 0.0, 0.0]])
    xyz, batch, offsets = _packed([c], 2)
    got = knn_op.knn(xyz, batch, offsets, 8)
    assert got[0].tolist() == [0, 1, 2, 3, 4, 5, -1, -1]
    assert got[1].tolist()[:4] == [1, 0, 2, 3]      # 0 at 2, 2 and 3 at 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_knn_route(device, monkeypatch):
    """A CPU tensor takes the plain version and counts no launch; a meta
    tensor raises with the route's message."""
    from wireframe_tpu_torch.ops import _launch

    xyz, batch, offsets = _packed(_random_clouds(4, (3, 9)), 2)
    if device == "meta":
        with pytest.raises(ValueError, match="the kNN search runs on CUDA "
                           "or CPU tensors, not meta"):
            knn_op.knn(*(t.to("meta") for t in (xyz, batch, offsets)), 8)
        return

    def stub(*args):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(knn_op, "_launch", stub)
    before = _launch.launch_counts(["knn"])
    got = knn_op.knn(xyz, batch, offsets, 8)
    assert torch.equal(got, knn_op.knn_plain(xyz, batch, offsets, 8))
    assert _launch.launch_counts(["knn"]) == before


@pytest.mark.parametrize("what", ["k", "xyz shape", "dtype", "rows",
                                  "offsets"])
def test_knn_wrapper_refuses(what):
    """What the kernel does not take raises before any library loads."""
    xyz, batch, offsets = _packed(_random_clouds(5, (3, 9)), 2)
    k = 16
    if what == "k":
        k = 12
    elif what == "xyz shape":
        xyz = xyz[:, :2]
    elif what == "dtype":
        xyz = xyz.double()
    elif what == "rows":
        xyz, batch = xyz[:0], batch[:0]
    else:
        offsets = offsets[:1]
    with pytest.raises(ValueError):
        knn_op._launch(xyz, batch, offsets, k)


def _kernel_transcribed(xyz, batch, offsets, k, threads, chunk):
    """csrc/knn.cu's block scheme in Python: a block of `threads` query
    rows takes the span of their clouds' rows, the `chunk` rows around its
    own first, then the rest of the span `chunk` at a time; each query
    walks its own cloud's staged rows from the block's first row up, then
    below it, and keeps its k best by the kernel's compare-and-swap pass
    on (distance, row)."""
    m, clouds = len(xyz), len(offsets) - 1
    x = xyz.numpy()
    off = offsets.tolist()
    out = np.full((m, k), -1, np.int64)
    for r0 in range(0, m, threads):
        rows = range(r0, min(r0 + threads, m))
        own = {r: (off[batch[r]], off[batch[r] + 1]) for r in rows
               if 0 <= batch[r] < clouds}
        if not own:
            continue
        s0 = min(a for a, _ in own.values())
        s1 = max(b for _, b in own.values())
        w0 = max(s0, min(r0 + threads // 2 - chunk // 2, s1 - chunk))
        w1 = min(w0 + chunk, s1)
        stages = [(w0, w1 - w0)] + [
            (c0, min(chunk, w0 - c0)) for c0 in range(s0, w0, chunk)] + [
            (c0, min(chunk, s1 - c0)) for c0 in range(w1, s1, chunk)]
        for r, (lo, hi) in own.items():
            bd, bi = [np.float32(np.inf)] * k, [-1] * k
            for c0, n in stages:
                a, e = max(lo - c0, 0), min(hi - c0, n)
                mid = min(max(r0 - c0, a), e)
                for i in list(range(mid, e)) + list(range(a, mid)):
                    d = x[c0 + i] - x[r]
                    dist = np.float32(np.float32(d[0] * d[0] + d[1] * d[1])
                                      + d[2] * d[2])
                    nd, nj = dist, c0 + i
                    if not (nd < bd[-1] or (nd == bd[-1] and nj < bi[-1])):
                        continue
                    for s in range(k):
                        if nd < bd[s] or (nd == bd[s] and nj < bi[s]):
                            bd[s], nd = nd, bd[s]
                            bi[s], nj = nj, bi[s]
            out[r] = bi
    return torch.from_numpy(out)


@pytest.mark.parametrize("threads,chunk", [(4, 3), (8, 64), (128, 2048)])
def test_kernel_transcription_equals_the_plain_search(threads, chunk):
    clouds = _random_clouds(7, (5, 40, 1, 23, 16, 9))
    xyz, batch, offsets = _packed(clouds, 5)
    want = knn_op.knn_plain(xyz, batch, offsets, 16)
    got = _kernel_transcribed(xyz, batch, offsets, 16, threads, chunk)
    assert torch.equal(got, want)


def test_knn_sizes_cover_the_published_neighbours():
    cfg = load_config(RECIPE, ["model.encoder=ptv2"])
    net = PTv2Backbone()
    m = cfg.model
    ks = {m.ptv2_patch_embed_neighbours, *m.ptv2_enc_neighbours,
          *m.ptv2_dec_neighbours, *net.level_k}
    assert ks <= set(knn_op.KNN_SIZES)
    # One search a level at its largest k: the patch embed's 8 are level
    # 0's first 8 of 16.
    assert net.level_k == [16, 16, 16, 16, 16]


def test_the_first_columns_are_the_smaller_search():
    xyz, batch, offsets = _packed(_random_clouds(8), 4)
    assert torch.equal(knn_op.knn(xyz, batch, offsets, 16)[:, :8],
                       knn_op.knn(xyz, batch, offsets, 8))


# --- levels: grid sampling and grid pooling ----------------------------------

def test_first_level_equals_grid_sampling():
    cfg = _cfg()
    x = _clouds()
    net = PointCloudToWireframe(cfg.model).encoder.backbone
    level, feats, slot, over = net._first_level(x)
    assert not bool(over)
    m, start = level.rows, 0
    for b in range(x.shape[0]):
        rows, _ = R.grid_sample(x[b], cfg.model.ptv2_grid_size)
        n = len(rows)
        # The kept rows in input row order, each cloud's rows one run.
        assert torch.equal(slot.reshape(x.shape[0], -1)[b][rows],
                           torch.arange(start, start + n))
        assert torch.equal(feats[start:start + n], x[b, rows])
        assert torch.equal(level.xyz[start:start + n], x[b, rows, :3])
        assert bool((level.batch[start:start + n] == b).all())
        start += n
    assert int(level.counts.sum()) == start == int(level.valid.sum())
    assert bool((slot[slot < m].bincount(minlength=m)[:start] == 1).all())


def test_grid_pooling_against_the_reference():
    """The same cells in the same order, the cell means equal (float64
    sums), the pooled features the cell max of ReLU(BN(Linear(x)))."""
    cfg = _cfg()
    model, w = _model(cfg)
    net = model.encoder.backbone
    x = _clouds()
    level, _, _, _ = net._first_level(x)
    gen = torch.Generator().manual_seed(5)
    h = torch.randn(level.rows, cfg.model.ptv2_patch_embed_channels,
                    generator=gen)
    m1 = capacity_rows(1.0, x.shape[0] * x.shape[1])
    gs = cfg.model.ptv2_grid_sizes[0]
    coarse, pooled, over = net._pool(level, h, net.enc[0].pool, m1,
                                     x.shape[0], gs)
    assert not bool(over)
    p = Precision(torch.float32)
    name = "encoder.backbone.enc.0.pool."
    fine0 = coarse0 = 0
    for b in range(x.shape[0]):
        n = int(level.counts[b])
        xyz = level.xyz[fine0:fine0 + n]
        inv, means = R.grid_pool_cells(xyz, gs)
        cells = len(means)
        assert torch.equal(level.parent[fine0:fine0 + n], inv + coarse0)
        assert torch.equal(coarse.xyz[coarse0:coarse0 + cells], means)
        f = R._bn_relu(w, name + "bn", R._lin(p, w, name + "proj",
                                              h[fine0:fine0 + n]))
        want = f.new_zeros((cells, f.shape[1])).scatter_reduce(
            0, inv[:, None].expand(-1, f.shape[1]), f, "amax",
            include_self=False)
        assert torch.allclose(pooled[coarse0:coarse0 + cells], want,
                              atol=1e-6)
        fine0, coarse0 = fine0 + n, coarse0 + cells
    assert int(coarse.counts.sum()) == coarse0 == int(coarse.valid.sum())
    assert bool((level.parent[fine0:] == m1).all())


def test_grid_clusters_flag_a_cell_past_16_bits():
    xyz = torch.tensor([[0.0, 0.0, 0.0], [70000.0, 0.0, 0.0]])
    key, over = voxel.grid_clusters(xyz, torch.zeros(2, dtype=torch.long),
                                    torch.ones(2, dtype=torch.bool), 1, 1.0)
    assert bool(over)
    _, over = voxel.grid_clusters(xyz[:1], torch.zeros(1, dtype=torch.long),
                                  torch.ones(1, dtype=torch.bool), 1, 1.0)
    assert not bool(over)


# --- one block, the whole forward ----------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.02)])
def test_block_against_the_reference(dtype, tol):
    """Level 4 of the small model: clouds of 1-4 rows, so most of the 16
    neighbour slots are missing."""
    cfg = _cfg(dtype)
    model, w = _model(cfg)
    net = model.encoder.backbone
    dt = net.dtype
    clouds = _random_clouds(9, (1, 4, 17, 3))
    xyz, batch, offsets = _packed(clouds, 5)
    counts = offsets[1:] - offsets[:-1]
    from wireframe_tpu_torch.models.ptv2 import Level

    level = Level(xyz=xyz, batch=batch, valid=batch < len(clouds),
                  counts=counts)
    net._neighbours(level, 4)
    c = cfg.model.ptv2_enc_channels[3]
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(len(xyz), c, generator=gen)
    with torch.inference_mode():
        got = net.enc[3].blocks[0](net, level, x, 16)
    p = Precision(dt)
    start = 0
    for cl in clouds:
        n = len(cl)
        want = R.block(p, w, "encoder.backbone.enc.3.blocks.0.",
                       x[start:start + n], cl, R.knn(cl, 16),
                       cfg.model.ptv2_enc_groups[3], True)
        assert (got[start:start + n] - want).abs().max() < tol
        start += n


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.01)])
def test_forward_against_the_reference(dtype, tol):
    cfg = _cfg(dtype)
    model, w = _model(cfg)
    x = _clouds()
    out = make_forward_fn(cfg)(model, x)
    p = Precision({"float32": torch.float32,
                   "bfloat16": torch.bfloat16}[dtype])
    m = dataclasses.asdict(cfg.model)
    with torch.no_grad():
        ref = R.forward(p, w, m, x)
    for k in ("vertices", "existence_probabilities", "edge_probs"):
        gap = (out[k].float() - ref[k].float()).abs().max().item()
        assert gap < tol, (k, gap)
    c = model.encoder.backbone.counters()
    assert c["calls"] == 1 and c["overflow_calls"] == 0
    assert c["input_rows"] == sum(SIZES)
    assert c["input_rows"] - c["grid_dropped"] == c["rows.level0"]
    # Every real row has min(cloud rows, 16) neighbours.
    assert c["knn_slots.level0"] == 16 * c["rows.level0"]


def test_planted_fault_fails_the_bf16_tolerance():
    cfg = _cfg("bfloat16")
    _, w = _model(cfg)
    x = _clouds()
    p = Precision(torch.bfloat16)
    m = dataclasses.asdict(cfg.model)
    with torch.no_grad():
        good = R.forward(p, w, m, x)
        bad = R.forward(p, w, m, x, skip_peb=("enc0.0",))
    assert (good["vertices"] - bad["vertices"]).abs().max() > 0.01


# --- capacity, serving, training ---------------------------------------------

def test_capacity_overflow_raises():
    cfg = _cfg(extra=["model.ptv2_capacity=1,0.05,1,1,1"])
    model, _ = _model(cfg)
    out = make_forward_fn(cfg)(model, _clouds())
    assert bool(out[OVERFLOW])
    with pytest.raises(CapacityOverflow, match="ptv2_capacity"):
        raise_on_overflow(out)
    assert model.encoder.backbone.counters()["overflow_calls"] == 1


def test_served_and_evaluated_after_an_overflow(tmp_path):
    from wireframe_tpu_torch.bridge import (
        save_port_checkpoint,
        state_dict_to_flax,
    )
    from wireframe_tpu_torch.eval.evaluator import make_forward_fn as serve_fn
    from wireframe_tpu_torch.serve import WireframePredictor

    cfg = _cfg(extra=["model.ptv2_capacity=0.1,1,1,1,1"])
    model, _ = _model(cfg)
    flat = state_dict_to_flax(model.state_dict(), cfg.model)
    forward = serve_fn(cfg, flat, device="cpu")
    with pytest.raises(CapacityOverflow):
        forward(_clouds().numpy())
    small = _clouds(seed=5, sizes=(40, 30, 50, 20)).numpy()
    got = forward(small)
    fresh = serve_fn(_cfg(), flat, device="cpu")(small)
    for k in got:
        assert np.allclose(got[k], fresh[k], atol=1e-5), k

    save_port_checkpoint(str(tmp_path), flat, cfg)
    with open(tmp_path / "config.json") as f:
        tree = json.load(f)["model"]
    assert tree["encoder"] == "ptv2" and "ptv2_enc_groups" in tree
    assert not any(k.startswith("ptv3_") for k in tree)
    pred = WireframePredictor(str(tmp_path), config=RECIPE,
                              overrides=["data.point_buckets=640",
                                         "eval.batch_size=4"],
                              device="cpu")
    assert pred.cfg.model.encoder == "ptv2"
    assert pred.cfg.model.ptv2_capacity == (0.1, 1.0, 1.0, 1.0, 1.0)
    rng = np.random.default_rng(6)
    big = [corpus.make_building(rng, n_points=n)[0] for n in (600, 600)]
    with pytest.raises(CapacityOverflow):
        pred.predict(big)
    assert len(pred.predict([corpus.make_building(rng, n_points=60)[0]])) \
        == 1


def test_training_is_refused():
    from wireframe_tpu_torch.train.step import make_train_step

    cfg = _cfg()
    with pytest.raises(ValueError, match="X-ptv2-train"):
        make_train_step(cfg)
    model, _ = _model(cfg)
    with pytest.raises(ValueError, match="X-ptv2-train"):
        model.encoder.backbone(_clouds(), train=True)


def test_reference_imports_no_port_and_no_jax():
    code = ("import sys, port_bench.reference.ptv2; print(sorted({m.split("
            "'.')[0] for m in sys.modules} & {'wireframe_tpu_torch', "
            "'wireframe_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# --- config keys ---------------------------------------------------------

def test_config_keys_and_published_widths():
    plain = config_to_dict(load_config(RECIPE))
    assert not any(k.startswith(("ptv2_", "ptv3_")) for k in plain["model"])
    ptv3 = config_to_dict(load_config(RECIPE, ["model.encoder=ptv3"]))
    assert not any(k.startswith("ptv2_") for k in ptv3["model"])
    tree = config_to_dict(_cfg())
    assert tree["model"]["encoder"] == "ptv2"
    assert not any(k.startswith("ptv3_") for k in tree["model"])
    assert tree["model"]["ptv2_enc_groups"] == (3, 6, 6, 8)
    net = PTv2Backbone()
    assert net.out_channels == 48 and len(net.enc) == len(net.dec) == 4
    assert [len(s.blocks) for s in net.enc] == [2, 2, 6, 2]
    assert [len(s.blocks) for s in net.dec] == [1, 1, 1, 1]
    assert len(net.patch_embed.blocks) == 1
    assert net.enc[2].blocks[0].attn.groups == 48
    assert net.dec[0].blocks[0].attn.groups == 6
    assert net.grid_sizes == (0.06, 0.12, 0.24, 0.48)


def test_benchmark_configuration_is_the_recipe_with_ptv2():
    """port_bench/configs/ptv2.json holds recommended.yaml as the program
    reads it, with only the keys under `changed` changed."""
    with open(os.path.join(ROOT, "port_bench", "configs", "ptv2.json")) as f:
        data = json.load(f)
    sets = [f"{k}=" + (",".join(map(str, v["to"])) if isinstance(
        v["to"], list) else str(v["to"])) for k, v in data["changed"].items()]
    shipped = config_to_dict(load_config(
        os.path.join(ROOT, data["source_file"]), sets))
    for sec, values in shipped.items():
        got = {k: (tuple(v) if isinstance(v, list) else v)
               for k, v in data[sec].items()}
        want = {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in values.items()}
        assert got == want, sec
    assert data["model"]["ptv2_enc_channels"] == [96, 192, 384, 512]
    assert data["model"]["ptv2_dec_groups"] == [6, 12, 24, 48]


# --- the cell's readers, counts and driver --------------------------------

LEVEL_ROWS = [608176, 92264, 20344, 5248, 1392]


KNN_KERNEL = ("void (anonymous namespace)::knn_kernel<16>(float const*, "
              "long long const*, long long const*, long long*, int, int)")
GVA_KERNEL = ("void (anonymous namespace)::gva_kernel<192, 16>((anonymous "
              "namespace)::Params)")


def _reading(device=((0.0, 0.001), (0.002, 0.0025)), device_name=H100,
             window=None, name=KNN_KERNEL):
    from port_bench import harness
    from port_bench.trace import Segment

    cell = harness.load_cell(ROOT, CELL)
    seg = Segment(device=[(name, a, b) for a, b in device]
                  + [("void at::native::vectorized_elementwise_kernel", 0.0,
                      1.0)], start=0.0, end=1.0, units=2)
    w = {"segment_units": 2, "ptv2_capacity_rows": LEVEL_ROWS,
         "ptv2_level_k": [16] * 5}
    w.update(window or {})
    return harness.Reading(cell=cell, device_name=device_name, window=w,
                           spans=None, segment=seg)


def test_knn_roofline_metric_arithmetic():
    """Each level's coordinates, cloud id and validity read once (21
    bytes a capacity row), its indices written once (8 bytes a slot), at
    3.35 TB/s, over the kernel's 0.75 ms a call."""
    from port_bench import harness

    read = harness.metric_module(ROOT, "ptv2_knn_roofline_pct.infer").read
    nbytes = sum(m * (21 + 8 * 16) for m in LEVEL_ROWS)
    assert read(_reading()) == pytest.approx(
        100.0 * nbytes / 3.35e12 / 0.75e-3, rel=1e-12)


@pytest.mark.parametrize("case", ["kernel never ran", "cpu", "no segment",
                                  "no rows"])
def test_knn_roofline_metric_is_none(case):
    from port_bench import harness

    read = harness.metric_module(ROOT, "ptv2_knn_roofline_pct.infer").read
    r = _reading(device=() if case == "kernel never ran" else
                 ((0.0, 0.001),), device_name="cpu" if case == "cpu"
                 else H100, window={"ptv2_capacity_rows": None}
                 if case == "no rows" else None)
    if case == "no segment":
        r.segment = None
    assert read(r) is None


GVA_COUNTERS = {"calls": 2, **{f"knn_slots.level{i}": 2 * 16 * n * 7 // 10
                               for i, n in enumerate(LEVEL_ROWS)}}


def test_gva_roofline_metric_arithmetic():
    """The 17 GVAs' products on the real slots (the level's kNN slots a
    call, half of them at the patch embed's k = 8) at the bf16 peak, or
    their bytes on the capacity rows at 3.35 TB/s, whichever is longer,
    over the kernel's 0.75 ms a call."""
    from port_bench import harness

    read = harness.metric_module(ROOT, "ptv2_gva_roofline_pct.infer").read
    gvas = ([(0, 48, 6, 8)] + [(1, 96, 12, 16)] * 2 + [(2, 192, 24, 16)] * 2
            + [(3, 384, 48, 16)] * 6 + [(4, 512, 64, 16)] * 2
            + [(0, 48, 6, 16), (1, 96, 12, 16), (2, 192, 24, 16),
               (3, 384, 48, 16)])
    flops = nbytes = 0.0
    for lv, c, g, k in gvas:
        slots = 16 * LEVEL_ROWS[lv] * 7 // 10 * k / 16
        flops += 2 * slots * (3 * c + c * c + c * g + g * g + c)
        nbytes += (LEVEL_ROWS[lv] * (2 * 3 * c + 12 + 8 * k + 4 * c)
                   + 4 * (c * c + g * c + g * g + 20 * c + 6 * g))
    least = max(flops / 989.4e12, nbytes / 3.35e12)
    r = _reading(name=GVA_KERNEL, window={"ptv2_counters": GVA_COUNTERS})
    assert read(r) == pytest.approx(100.0 * least / 0.75e-3, rel=1e-12)


@pytest.mark.parametrize("case", ["kernel never ran", "cpu", "no segment",
                                  "no counters", "no rows"])
def test_gva_roofline_metric_is_none(case):
    """None on the parent (no gva_kernel in the trace), on the CPU, and
    where the window lacks what it reads."""
    from port_bench import harness

    read = harness.metric_module(ROOT, "ptv2_gva_roofline_pct.infer").read
    window = {"ptv2_counters": GVA_COUNTERS}
    if case == "no counters":
        window["ptv2_counters"] = None
    if case == "no rows":
        window["ptv2_capacity_rows"] = None
    r = _reading(name=KNN_KERNEL if case == "kernel never ran"
                 else GVA_KERNEL, device_name="cpu" if case == "cpu"
                 else H100, window=window)
    if case == "no segment":
        r.segment = None
    assert read(r) is None


def test_pad_and_mfu_readers():
    from port_bench import harness

    pad = harness.metric_module(ROOT, "ptv2_pad_pct.infer").read
    mfu = harness.metric_module(ROOT, "ptv2_mfu.infer").read
    r = _reading(window={"ptv2_counters": {"gva_real_slots": 400,
                                           "gva_slots": 1000},
                         "clouds": 1000, "wall": 2.0,
                         "ptv2_flops_per_cloud": 3.4e9})
    assert pad(r) == pytest.approx(150.0)
    assert mfu(r) == pytest.approx(100.0 * 3.4e9 * 500 / 989.4e12)
    assert pad(_reading()) is None and mfu(_reading()) is None


def test_operation_counts():
    """`counts_ptv2` on a record: the patch embed, every block's rows and
    real slots (n * min(n, k)), the pools and the projection."""
    from port_bench import counts, counts_ptv2

    cfg = load_config(RECIPE, ["model.encoder=ptv2"])
    m = dataclasses.asdict(cfg.model)
    rec = {"rows": [3000, 450, 100, 25, 7]}
    got = counts_ptv2.backbone_flops(m, rec)

    def blk(n, c, g, k=16):
        s = n * min(n, k)
        return 2 * n * 5 * c * c + 2 * s * (4 * c + c * c + c * g + g * g)

    want = 2 * 3000 * 8 * 48 + blk(3000, 48, 6, k=8)
    enc_c, rows = [48, 96, 192, 384, 512], rec["rows"]
    for s, (d, g) in enumerate(zip((2, 2, 6, 2), (12, 24, 48, 64))):
        want += 2 * rows[s] * enc_c[s] * enc_c[s + 1]
        want += d * blk(rows[s + 1], enc_c[s + 1], g)
    dec_c = [48, 96, 192, 384, 512]
    for s, g in enumerate((6, 12, 24, 48)):
        want += 2 * (rows[s + 1] * dec_c[s + 1] + rows[s] * enc_c[s]) \
            * dec_c[s]
        want += blk(rows[s], dec_c[s], g)
    want += 2 * 3000 * 48 * 512
    assert got == pytest.approx(want, rel=1e-12)
    assert counts_ptv2.forward_flops(m, rec, 16384) == pytest.approx(
        got + counts.forward_flops_per_cloud(m, 16384)
        - counts.point_mlp_flops(m) * 16384, rel=1e-12)


def test_cell_driver_on_the_cpu(tmp_path):
    """The cell's driver at a cut size: set-up, a short window, the
    counters and counts its readers take, and the check against the
    reference within the cut cells' limits."""
    from port_bench import harness
    from port_bench.tests import tiny

    root = tiny.make_root(str(tmp_path))
    path = os.path.join(root, "port_bench", "configs", "ptv2.json")
    with open(path) as f:
        conf = json.load(f)
    conf["model"]["ptv2_capacity"] = [1, 1, 1, 1, 1]
    conf["data"]["num_points"] = 256
    with open(path, "w") as f:
        json.dump(conf, f)
    cell = harness.load_cell(root, CELL)
    cell.traffic["batch"] = 2
    driver = harness.driver_class(cell)(cell, 3000000001,
                                        torch.device("cpu"), harness.Spans())
    driver.setup()
    values, window = driver.window(0.05)
    assert values["infer_clouds_per_s"] > 0
    c = window["ptv2_counters"]
    assert c["calls"] == window["calls"] + 0 and c["overflow_calls"] == 0
    assert window["ptv2_level_k"] == [16] * 5
    assert window["ptv2_flops_per_cloud"] > 0
    driver.free()
    checks = driver.check()
    assert all(v <= lim for v, lim in checks.values()), checks
    fault = driver.fault_numbers()
    assert fault["vertex_gap"] > 0


# --- the GVA kernel's wrapper, rule and blocking -----------------------------

def _gva_level(c, seed=11, sizes=(1, 2, 3, 4, 17), pad=5):
    """A GVA at width C (C / 8 groups) with seeded parameters and running
    statistics off 0 and 1, a level of clouds of 1-4 rows (and one of 17)
    with `pad` dummy rows and its k = 16 neighbours, and x (M, C)."""
    from wireframe_tpu_torch.models.ptv2 import GVA, Level

    gen = torch.Generator().manual_seed(seed)
    attn = GVA(c, c // 8)
    with torch.no_grad():
        for name, t in attn.named_parameters():
            fan = t.shape[-1] if t.dim() > 1 else 1
            t.copy_(torch.randn(t.shape, generator=gen) / fan ** 0.5)
        for name, t in attn.named_buffers():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            else:
                t.copy_(0.3 * torch.randn(t.shape, generator=gen))
    clouds = _random_clouds(seed, sizes)
    xyz, batch, offsets = _packed(clouds, pad)
    level = Level(xyz=xyz, batch=batch, valid=batch < len(clouds),
                  counts=offsets[1:] - offsets[:-1])
    level.nbr = knn_op.knn(xyz, batch, offsets, 16)
    level.gather = torch.where(level.nbr >= 0, level.nbr,
                               torch.full_like(level.nbr, len(xyz)))
    x = torch.randn(len(xyz), c, generator=gen)
    return attn.eval(), level, x


def _gva_transcribed(attn, level, x, k, dt):
    """csrc/gva.cu's blocking in Python: the block's parameters folded
    from the running statistics and its weights rounded to `dt` as they
    are staged; each warp's 16 pair rows (16 / k query rows); pe2 and then
    we1 by chunks of 16 output columns (we1's padded to 16 groups); we1's
    epilogue and we2 in the warp; the softmax over each query row's k
    slots; the weighted sum in slot order; a warp whose rows have no
    neighbour writes 0 and counts its rows.  Returns (out, rows
    skipped)."""
    def rd(t):
        return t.to(dt).float()

    def fold(bn):
        scale = torch.rsqrt(bn.running_var + 1e-5) * bn.weight
        return scale, bn.bias - bn.running_mean * scale

    def lin_out(prod, bias):
        return rd(rd(prod) + rd(bias))

    m, c = x.shape
    g = attn.groups
    gp = -(-g // 16) * 16
    pes, pet = fold(attn.pe_bn)
    qs, qt = fold(attn.q_bn)
    ks, kt = fold(attn.k_bn)
    ws, wt = fold(attn.we_bn)
    w1, w2 = rd(attn.pe1.weight), rd(attn.pe2.weight)
    we1 = torch.zeros(gp, c)
    we1[:g] = rd(attn.we1.weight)
    be1, be2 = torch.zeros(gp), torch.zeros(gp)
    be1[:g], be2[:g] = attn.we1.bias, attn.we2.bias
    ws = torch.cat([ws, torch.zeros(gp - g)])
    wt = torch.cat([wt, torch.zeros(gp - g)])
    we2 = torch.zeros(gp, gp)
    we2[:g, :g] = rd(attn.we2.weight)
    xb = rd(x)
    qp, kp, vp = (rd(xb @ rd(lin.weight).t())
                  for lin in (attn.q, attn.k, attn.v))
    nbr = level.nbr[:, :k]
    out = torch.full((m, c), float("nan"))
    skipped, per_warp = 0, 16 // k
    for i0 in range(0, m, per_warp):
        rows = torch.arange(i0, i0 + per_warp)
        qrow = rows.repeat_interleave(k)                # pair row -> i
        j = torch.full((16,), -1, dtype=torch.long)
        real = qrow < m
        j[real] = nbr[qrow[real], torch.arange(16)[real] % k]
        has = j >= 0
        if not has.any():
            out[i0:min(i0 + per_warp, m)] = 0.0
            skipped += min(per_warp, m - i0)
            continue
        qi, jj = qrow.clamp_max(m - 1), j.clamp_min(0)
        pos = torch.where(has[:, None], level.xyz[jj] - level.xyz[qi], 0.0)
        h = torch.relu(lin_out(rd(pos) @ w1.t(), attn.pe1.bias) * pes + pet)
        h = rd(h)
        peb = torch.cat([lin_out(h @ w2[s:s + 16].t(), attn.pe2.bias[s:s + 16])
                         for s in range(0, c, 16)], 1)
        q = torch.relu(lin_out(qp[qi], attn.q.bias) * qs + qt)
        q = torch.where(real[:, None], q, 0.0)
        kj = torch.relu(lin_out(kp[jj], attn.k.bias) * ks + kt)
        kj = torch.where(has[:, None], kj, 0.0)
        rel = rd((kj - q) + peb)
        accw = torch.cat([rel @ we1[t:t + 16].t() for t in range(0, gp, 16)],
                         1)
        e = rd(torch.relu(lin_out(accw, be1) * ws + wt))
        logits = lin_out(e @ we2.t(), be2)[:, :g].reshape(per_warp, k, g)
        w = torch.softmax(logits, dim=1) * has.reshape(per_warp, k, 1)
        v = torch.where(has[:, None], lin_out(vp[jj], attn.v.bias), 0.0)
        val = (v + peb).reshape(per_warp, k, g, c // g)
        for r in range(per_warp):
            if i0 + r >= m:
                break
            acc = torch.zeros(g, c // g)
            for s in range(k):
                acc = acc + val[r, s] * w[r, s][:, None]
            out[i0 + r] = acc.reshape(c)
    return out, skipped


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.01)])
@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("c", [48, 512])
def test_gva_kernel_transcription_equals_the_plain_version(c, k, dtype, tol):
    from wireframe_tpu_torch.ops import gva as gva_op

    attn, level, x = _gva_level(c)
    with torch.inference_mode():
        want = gva_op.gva_plain(attn, level, x, k, dtype)
        got, skipped = _gva_transcribed(attn, level, x, k, dtype)
    assert (got - want).abs().max() < tol
    dead = ~(level.nbr[:, :k] >= 0).any(1)
    assert bool((got[dead] == 0).all()) and bool((want[dead] == 0).all())
    # The 5 dummy rows, less one at k = 8 that shares a warp with a real
    # row (27 real rows).
    assert int(dead.sum()) == 5 and skipped == (5 if k == 16 else 4)


@pytest.mark.parametrize("device", ["cpu", "meta", "cuda"])
def test_gva_route(device, monkeypatch):
    """A CPU tensor takes the plain version and counts no launch; a meta
    tensor raises with the route's message; a CUDA tensor (the route
    patched to take it, the launch stubbed) goes to the kernel."""
    from wireframe_tpu_torch.ops import _launch
    from wireframe_tpu_torch.ops import gva as gva_op

    attn, level, x = _gva_level(48)
    if device == "meta":
        with pytest.raises(ValueError, match="the GVA runs on CUDA or CPU "
                           "tensors, not meta"):
            gva_op.gva(attn, level, x.to("meta"), 16, torch.bfloat16)
        return
    taken = []

    def stub(*args):
        taken.append(args)
        return "kernel"

    monkeypatch.setattr(gva_op, "_launch", stub)
    if device == "cuda":
        monkeypatch.setattr(gva_op, "on_card", lambda t, what: True)
        counters = torch.zeros(3, dtype=torch.long)
        assert gva_op.gva(attn, level, x, 16, torch.bfloat16,
                          counters) == "kernel"
        assert taken == [(attn, level, x, 16, torch.bfloat16, counters)]
        return
    before = _launch.launch_counts(["gva"])
    with torch.inference_mode():
        got = gva_op.gva(attn, level, x, 16, torch.bfloat16)
        want = gva_op.gva_plain(attn, level, x, 16, torch.bfloat16)
    assert torch.equal(got, want) and not taken
    assert _launch.launch_counts(["gva"]) == before


@pytest.mark.parametrize("device,dtype,grad,want", [
    ("cuda", torch.bfloat16, False, True),
    ("cuda", torch.float32, False, False),
    ("cuda", torch.bfloat16, True, False),
    ("cpu", torch.bfloat16, False, False),
])
def test_gva_engages(device, dtype, grad, want, monkeypatch):
    """The kernel for CUDA, bf16 and autograd off; GVA.forward follows the
    rule and hands the kernel the backbone's three GVA counters, or counts
    the plain version's slots itself."""
    from wireframe_tpu_torch.ops import gva as gva_op

    assert gva_op.engages(torch.device(device), dtype, grad) is want
    attn, level, x = _gva_level(48)
    calls = []
    monkeypatch.setattr(gva_op, "engages", lambda *a: want)
    monkeypatch.setattr(gva_op, "gva",
                        lambda *a: calls.append(a) or "kernel")
    net = PTv2Backbone()
    got = attn(level, x, 16, dtype, net.gva_counters())
    c = net.counters()
    if want:
        assert got == "kernel" and calls[0][-1].data_ptr() == \
            net.counter_values[4].data_ptr()
        assert c["gva_real_slots"] == c["gva_slots"] == 0
    else:
        assert not calls and got.shape == x.shape
        assert c["gva_real_slots"] == int((level.nbr >= 0).sum())
        assert c["gva_slots"] == 16 * len(x) and c["gva_rows_skipped"] == 0


@pytest.mark.parametrize("what", ["width", "group ratio", "k", "dtype",
                                  "nbr layout", "xyz layout",
                                  "parameter dtype", "counters"])
def test_gva_wrapper_refuses(what):
    """What the kernel does not take raises before any library loads."""
    from wireframe_tpu_torch.models.ptv2 import GVA
    from wireframe_tpu_torch.ops import gva as gva_op

    c, k, dt, counters = 48, 16, torch.bfloat16, None
    attn, level, x = _gva_level(c)
    if what == "width":
        attn, x = GVA(56, 7), torch.zeros(len(x), 56)
    elif what == "group ratio":
        attn = GVA(48, 12)
    elif what == "k":
        k = 12
    elif what == "dtype":
        dt = torch.float32
    elif what == "nbr layout":
        level.nbr = level.nbr.t().contiguous().t()
    elif what == "xyz layout":
        level.xyz = level.xyz.t().contiguous().t()
    elif what == "parameter dtype":
        attn.pe2.weight.data = attn.pe2.weight.data.double()
    else:
        counters = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError):
        gva_op._launch(attn, level, x, k, dt, counters)


def test_gva_widths_cover_the_published_configuration():
    from wireframe_tpu_torch.ops import gva as gva_op

    cfg = load_config(RECIPE, ["model.encoder=ptv2"])
    m = cfg.model
    shapes = {(m.ptv2_patch_embed_channels, m.ptv2_patch_embed_groups,
               m.ptv2_patch_embed_neighbours)}
    for cs, gs, ks in ((m.ptv2_enc_channels, m.ptv2_enc_groups,
                        m.ptv2_enc_neighbours),
                       (m.ptv2_dec_channels, m.ptv2_dec_groups,
                        m.ptv2_dec_neighbours)):
        shapes |= set(zip(cs, gs, ks))
    for c, g, k in shapes:
        plan = gva_op.gva_plan(608176, c, g, k)
        assert plan["smem"] <= 232448 and plan["rows"] * k == 16 * \
            plan["warps"]
