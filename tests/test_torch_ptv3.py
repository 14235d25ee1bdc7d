"""The port's Point Transformer V3 encoder (`model.encoder: ptv3`) on the
CPU at small widths (patch size 16, clouds of 128-600 points), against
the benchmark's plain reference (`port_bench/reference/ptv3.py`) or
brute force:

- Morton and Hilbert codes, plain and "-trans": each curve visits every
  cell of a small grid once, consecutive Hilbert cells are neighbours,
  and the port's 16-bit codes with its axis rotation equal the
  reference's codes at the batch's own depth;
- the k=3 and k=5 neighbour maps against a brute-force search, by the
  plain version and through the wrapper's CPU route; a meta tensor
  raises; a level of dummies only, grid coordinates at 0 and 0xFFFF,
  clouds over the same cells, the smallest capacity; the kernel's table
  size and refusals, and its arithmetic (dilated Morton addition, hash
  table, linear probing) transcribed, against the plain map in random
  insertion orders (the kernel itself runs on the card: `chip_smoke.py`'s
  ptv3 phase); `ptv3_map_roofline_pct.infer`'s arithmetic;
- the patch padding rule for clouds above and below the patch size,
  against a transcription of Pointcept's `get_padding_and_inverse`;
- grid coordinates and grid sampling exactly equal to the reference's;
- pooling and unpooling against the reference's per-cloud clusters;
- the whole forward against the reference on seeded weights: float32
  within 1e-5 (the two differ in summation order only: ~2e-7 seen),
  bfloat16 within 0.02 (operands rounded to bf16 at every product; the
  reference's per-cloud and the port's packed products round apart,
  ~0.005 seen, and a planted fault, one CPE left out, moves ~0.05);
- a capacity overflow raises when the outputs are read (serving,
  evaluation, the train loop's metrics), no point is dropped silently,
  and the next call that fits is served as a fresh model serves it;
- one `make_train_step` step: a finite loss, a finite gradient on every
  backbone parameter, nonzero on all but a few, and BatchNorm batch
  statistics unchanged when padding rows are appended;
- a ptv3 checkpoint round trip through the bridge, served on the CPU;
- the config keys: a pointnet tree is the JAX package's, a ptv3 tree
  round-trips.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from port_bench import corpus
from port_bench.drivers.infer_ptv3 import ptv3_weights
from port_bench.reference import ptv3 as R
from port_bench.reference.model import Precision
from wireframe_tpu_torch.config import config_to_dict, load_config
from wireframe_tpu_torch.models.ptv3 import (
    OVERFLOW,
    CapacityOverflow,
    PTv3Backbone,
    capacity_rows,
    raise_on_overflow,
)
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.ops import voxel
from wireframe_tpu_torch.ops.patch_attention import (
    attention_capacity,
    patch_layout,
    segment_attention,
)
from wireframe_tpu_torch.train.step import make_forward_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
SMALL = ["model.encoder=ptv3", "model.ptv3_enc_channels=8,16,16,32,32",
         "model.ptv3_enc_num_head=1,2,2,4,4",
         "model.ptv3_dec_channels=16,16,16,32",
         "model.ptv3_dec_num_head=2,2,2,4", "model.ptv3_patch_size=16",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "model.edge_hidden_dim=32", "model.edge_num_heads=4",
         "model.encoder_output_dim=32", "model.ptv3_grid_size=0.08",
         "model.ptv3_capacity=1,1,1,1,1", "data.num_points=640",
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


# --- serialization ---------------------------------------------------------

@pytest.mark.parametrize("order", ORDERS)
def test_curve_visits_every_cell_once(order):
    g = torch.cartesian_prod(*[torch.arange(8)] * 3)
    code = voxel.curve_codes(g, [order], torch.tensor(3))[0]
    assert torch.equal(torch.sort(code).values, torch.arange(512))
    if order.startswith("hilbert"):
        path = g[torch.argsort(code)]
        assert bool(((path[1:] - path[:-1]).abs().sum(1) == 1).all())


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 7, 8])
def test_codes_equal_the_reference_at_its_depth(depth):
    gen = torch.Generator().manual_seed(depth)
    g = torch.randint(0, 2 ** depth, (400, 3), generator=gen)
    g[0] = 2 ** depth - 1
    d = voxel.depth_of(g, torch.ones(400, dtype=torch.bool))
    assert int(d) == depth
    codes = voxel.curve_codes(g, ORDERS, d)
    for i, order in enumerate(ORDERS):
        assert torch.equal(codes[i], R.encode(g, order, depth)), order


def test_morton_is_bit_interleaving_x_first():
    g = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [3, 5, 6]])
    assert voxel.morton_encode(g).tolist() == [4, 2, 1, R.morton(
        g[3:], 3).item()]


# --- neighbours ------------------------------------------------------------

def _brute_force(grid, batch, valid, size):
    """The map by comparing every valid row's neighbour cells with every
    valid row, and its pairs."""
    m = len(grid)
    r = size // 2
    offsets = torch.cartesian_prod(*[torch.arange(-r, r + 1)] * 3)
    want = torch.full((m, size ** 3), m)
    for i in torch.nonzero(valid).squeeze(1).tolist():
        for k, o in enumerate(offsets):
            hit = ((grid == grid[i] + o).all(1) & (batch == batch[i])
                   & valid).nonzero()
            if len(hit):
                want[i, k] = hit[0, 0]
    return want, int((want < m).sum())


def _packed(grids, pad):
    """A level of the clouds' voxels `grids`, sorted by key, then `pad`
    dummy rows: (key, grid, batch, valid)."""
    batch = torch.cat([torch.full((len(g),), i, dtype=torch.long)
                       for i, g in enumerate(grids)])
    grid = torch.cat(grids).long()
    key = (batch << voxel.BATCH_SHIFT) | voxel.morton_encode(grid)
    order = torch.argsort(key)
    key, grid, batch = key[order], grid[order], batch[order]
    key = torch.cat([key, torch.full((pad,), voxel.DUMMY_KEY)])
    grid = torch.cat([grid, torch.zeros(pad, 3, dtype=torch.long)])
    batch = torch.cat([batch, torch.full((pad,), len(grids))])
    return key, grid, batch, key != voxel.DUMMY_KEY


@pytest.mark.parametrize("size", [3, 5])
def test_neighbour_map_against_brute_force(size):
    """`neighbour_map_plain`, and `neighbour_map` on CPU tensors, against
    a brute-force search and the reference's dense-table search."""
    gen = torch.Generator().manual_seed(size)
    grids = [torch.unique(torch.randint(0, 6, (120, 3), generator=gen),
                          dim=0) for _ in range(2)]
    pad = 5                                          # dummy rows last
    key, grid, batch, valid = _packed(grids, pad)
    m = len(key)
    want, want_pairs = _brute_force(grid, batch, valid, size)
    for fn in (voxel.neighbour_map_plain, voxel.neighbour_map):
        nbr, pairs = fn(key, grid, batch, valid, size)
        assert torch.equal(nbr, want)
        assert int(pairs) == want_pairs
    # The reference's dense-table search, cloud by cloud.
    start = 0
    for b in range(2):
        n = int((batch == b).sum())
        local = nbr[start:start + n]
        local = torch.where(local < m, local - start, torch.full_like(
            local, n))
        assert torch.equal(local, R.neighbours(grid[start:start + n], size))
        start += n


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_neighbour_map_route(device, monkeypatch):
    """A CPU tensor takes the plain version and counts no launch; a meta
    tensor raises with the route's message."""
    from wireframe_tpu_torch.ops import _launch

    key, grid, batch, valid = _packed([torch.tensor([[1, 1, 1], [1, 1, 2]])],
                                      2)
    if device == "meta":
        args = [t.to("meta") for t in (key, grid, batch, valid)]
        with pytest.raises(ValueError, match="the neighbour map runs on "
                           "CUDA or CPU tensors, not meta"):
            voxel.neighbour_map(*args, 3)
        return
    monkeypatch.setattr(voxel, "_launch_map", _stub)
    before = _launch.launch_counts(["neighbour map"])
    nbr, pairs = voxel.neighbour_map(key, grid, batch, valid, 3)
    want, _ = voxel.neighbour_map_plain(key, grid, batch, valid, 3)
    assert torch.equal(nbr, want) and int(pairs) == 4   # itself, the other
    assert _launch.launch_counts(["neighbour map"]) == before


class _Reached(Exception):
    pass


def _stub(*args, **kwargs):
    raise _Reached


def _edge_level(case):
    """(grids a cloud, dummy rows) of each edge case."""
    top = 0xFFFF
    if case == "dummies only":
        return [], 8
    if case == "grid edges":
        return [torch.tensor([[0, 0, 0], [0, 0, 1], [1, 1, 0], [top, top,
                              top], [top, top - 1, top], [top - 2, top,
                              top], [0, top, 0], [0, top, 1]])], 3
    if case == "cloud boundary":
        # Two clouds over the same cells: none sees the other's voxels.
        cells = torch.tensor([[2, 2, 2], [2, 2, 3], [3, 2, 2], [4, 4, 4]])
        return [cells, cells.clone()], 0
    return [torch.tensor([[5, 5, 5], [5, 6, 5], [6, 6, 6]]),
            torch.tensor([[5, 5, 5]])], 4            # M = 8


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("case", ["dummies only", "grid edges",
                                  "cloud boundary", "smallest capacity"])
def test_neighbour_map_edge_cases(case, size):
    grids, pad = _edge_level(case)
    if grids:
        key, grid, batch, valid = _packed(grids, pad)
    else:
        key = torch.full((pad,), voxel.DUMMY_KEY)
        grid = torch.zeros(pad, 3, dtype=torch.long)
        batch, valid = torch.zeros(pad, dtype=torch.long), key < 0
    m = len(key)
    nbr, pairs = voxel.neighbour_map(key, grid, batch, valid, size)
    want, want_pairs = _brute_force(grid, batch, valid, size)
    assert torch.equal(nbr, want) and int(pairs) == want_pairs
    assert bool((nbr[~valid] == m).all())
    if case == "dummies only":
        assert int(pairs) == 0 and bool((nbr == m).all())
    elif case == "grid edges":
        # Offsets past 0 or 0xFFFF find nothing; the corner voxels find
        # each other.
        corner = int(torch.nonzero((grid == 0xFFFF).all(1))[0, 0])
        r = size // 2
        k = size ** 3 - 1            # (+r, +r, +r): past the top
        assert int(nbr[corner, k]) == m
        centre = (size ** 3) // 2
        assert int(nbr[corner, centre]) == corner
        assert int(nbr[corner, centre - size]) < m   # (0, -1, 0)
        origin = int(torch.nonzero((grid == 0).all(1))[0, 0])
        assert bool((nbr[origin, :r * size * size] == m).all())  # dx < 0
    elif case == "cloud boundary":
        for i in range(m):
            hits = nbr[i][nbr[i] < m]
            assert bool((batch[hits] == batch[i]).all())
        assert want_pairs > 4
    else:
        assert m == 8 and want_pairs > 4


@pytest.mark.parametrize("m", [1, 8, 9, 3992, 14056, 54528, 203424, 608176,
                               1 << 20])
def test_neighbour_table_size(m):
    """The kernel's hash table: a power of two of at least 2M slots (at
    most half full), under 4M; 2**21 at the cell's level 0."""
    slots = voxel.table_slots(m)
    assert slots & (slots - 1) == 0 and 2 * m <= slots < 4 * m
    if m == 608176:
        assert slots == 1 << 21


@pytest.mark.parametrize("what", ["size", "grid shape", "dtype", "rows"])
def test_neighbour_map_wrapper_refuses(what):
    """What the kernel does not take raises before any library loads."""
    key, grid, batch, valid = _packed([torch.tensor([[1, 1, 1]])], 7)
    size = 3
    if what == "size":
        size = 7
    elif what == "grid shape":
        grid = grid[:, :2]
    elif what == "dtype":
        batch = batch.int()
    else:
        key = key[:0]
    with pytest.raises(ValueError):
        voxel._launch_map(key, grid, batch, valid, size)


# The kernel's arithmetic, transcribed: csrc/neighbour_map.cu's spread
# bits, dilated addition, multiplicative hash and linear probing.
DILATED = 0x1249249249249249
U64 = (1 << 64) - 1


def _dilated_add(s, d):
    step = 8 if abs(d) == 2 else abs(d)
    return (((s | (~DILATED & U64)) + step) & DILATED if d >= 0
            else (s - step) & DILATED)


def test_dilated_addition_is_the_spread_of_the_sum():
    coords = list(range(0, 40)) + list(range(0xFFFF - 40, 0x10000)) + [
        0x5555, 0xAAAA, 0x7FFF, 0x8000, 0x0FFF, 0x1000]
    c = torch.tensor(coords)
    for d in range(-2, 3):
        inside = (c + d >= 0) & (c + d <= 0xFFFF)
        want = voxel._spread(c + d)
        got = [_dilated_add(int(s), d) for s in voxel._spread(c)]
        assert [g for g, i in zip(got, inside) if i] == want[inside].tolist()


def _emulate_kernel(key, grid, batch, valid, size, order):
    """The kernel's table built inserting the valid rows in `order`, then
    every query looked up."""
    m = len(key)
    slots = voxel.table_slots(m)
    shift = 64 - (slots.bit_length() - 1)
    keys = [k & U64 for k in key.tolist()]
    table = [0] * slots

    def slot_of(k):
        return ((k * 0x9E3779B97F4A7C15) & U64) >> shift

    for r in order:
        h = slot_of(keys[r])
        while table[h] and keys[table[h] - 1] != keys[r]:
            h = (h + 1) % slots
        table[h] = min(table[h] or r + 1, r + 1)
    r_ = size // 2
    offsets = torch.cartesian_prod(*[torch.arange(-r_, r_ + 1)] * 3)
    nbr, pairs = torch.full((m, size ** 3), m), 0
    for i in torch.nonzero(valid).squeeze(1).tolist():
        s = [int(v) for v in voxel._spread(grid[i])]
        for k, o in enumerate(offsets.tolist()):
            g = [int(grid[i, a]) + o[a] for a in range(3)]
            if not all(0 <= v <= 0xFFFF for v in g):
                continue
            code = ((_dilated_add(s[0], o[0]) << 2)
                    | (_dilated_add(s[1], o[1]) << 1)
                    | _dilated_add(s[2], o[2]))
            q = (int(batch[i]) << voxel.BATCH_SHIFT) | code
            h = slot_of(q)
            while table[h] and keys[table[h] - 1] != q:
                h = (h + 1) % slots
            if table[h]:
                nbr[i, k] = table[h] - 1
                pairs += 1
    return nbr, pairs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_transcription_equals_the_plain_map(seed):
    """Insertion order (the atomics' race) moves where a key lands, never
    a lookup's answer."""
    gen = torch.Generator().manual_seed(10 + seed)
    grids = [torch.unique(torch.randint(0, 7, (150, 3), generator=gen),
                          dim=0) for _ in range(3)]
    key, grid, batch, valid = _packed(grids, 6)
    order = torch.nonzero(valid).squeeze(1)[torch.randperm(
        int(valid.sum()), generator=gen)].tolist()
    for size in (3, 5):
        nbr, pairs = _emulate_kernel(key, grid, batch, valid, size, order)
        want, want_pairs = voxel.neighbour_map_plain(key, grid, batch,
                                                     valid, size)
        assert torch.equal(nbr, want) and pairs == int(want_pairs)


# The map roofline's reader, on a fake profiled window of two calls at the
# cell's capacities.
MAP_METRIC = "ptv3_map_roofline_pct.infer"
LEVEL_ROWS = [608176, 203424, 54528, 14056, 3992]
H100 = "NVIDIA H100 80GB HBM3"


def _map_reading(device=((0.0, 0.001), (0.002, 0.0025)), device_name=H100,
                 rows=True):
    from port_bench import harness
    from port_bench.trace import Segment

    cell = harness.load_cell(ROOT, "ptv3-infer-b128-16k")
    names = ["void (anonymous namespace)::nbr_query_kernel<5>((anonymous "
             "namespace)::Params)", "(anonymous namespace)::nbr_table_kernel"
             "((anonymous namespace)::Params)"]
    seg = Segment(device=[(names[i % 2], a, b) for i, (a, b) in
                          enumerate(device)]
                  + [("void at::native::vectorized_elementwise_kernel", 0.0,
                      1.0)], start=0.0, end=1.0, units=2)
    window = {"segment_units": 2,
              "ptv3_capacity_rows": LEVEL_ROWS if rows else None}
    return harness.Reading(cell=cell, device_name=device_name,
                           window=window, spans=None, segment=seg)


def test_map_roofline_metric_arithmetic():
    """Each level's inputs read once (41 bytes a capacity row), the six
    maps written once, at 3.35 TB/s, over the kernels' 0.75 ms a call."""
    from port_bench import harness

    read = harness.metric_module(ROOT, MAP_METRIC).read
    nbytes = 41 * sum(LEVEL_ROWS) + 8 * 125 * LEVEL_ROWS[0] + sum(
        8 * 27 * m for m in LEVEL_ROWS)
    assert nbytes / 3.35e12 == pytest.approx(2.494e-4, rel=1e-3)
    assert read(_map_reading()) == pytest.approx(
        100.0 * nbytes / 3.35e12 / 0.75e-3, rel=1e-12)


@pytest.mark.parametrize("case", ["kernels never ran", "cpu", "no segment",
                                  "no rows"])
def test_map_roofline_metric_is_none(case):
    from port_bench import harness

    read = harness.metric_module(ROOT, MAP_METRIC).read
    r = _map_reading(device=() if case == "kernels never ran" else
                     ((0.0, 0.001),), device_name="cpu" if case == "cpu"
                     else H100, rows=case != "no rows")
    if case == "no segment":
        r.segment = None
    assert read(r) is None


# --- the padding rule ------------------------------------------------------

def _pointcept_padding(counts, patch):
    """Pointcept's `get_padding_and_inverse`, transcribed."""
    offset = np.cumsum(counts)
    bincount = np.asarray(counts)
    pad_count = (bincount + patch - 1) // patch * patch
    mask_pad = bincount > patch
    pad_count = ~mask_pad * bincount + mask_pad * pad_count
    _offset = np.concatenate([[0], offset])
    _offset_pad = np.concatenate([[0], np.cumsum(pad_count)])
    pad = np.arange(_offset_pad[-1])
    unpad = np.arange(_offset[-1])
    cu = []
    for i in range(len(offset)):
        unpad[_offset[i]:_offset[i + 1]] += _offset_pad[i] - _offset[i]
        if bincount[i] != pad_count[i]:
            pad[_offset_pad[i + 1] - patch + (bincount[i] % patch):
                _offset_pad[i + 1]] = pad[
                _offset_pad[i + 1] - 2 * patch + (bincount[i] % patch):
                _offset_pad[i + 1] - patch]
        pad[_offset_pad[i]:_offset_pad[i + 1]] -= _offset_pad[i] - _offset[i]
        cu.append(np.arange(_offset_pad[i], _offset_pad[i + 1], patch))
    return pad, unpad, np.concatenate(cu + [[_offset_pad[-1]]])


@pytest.mark.parametrize("counts", [(40, 9), (16, 33, 0, 5), (7,)])
def test_padding_rule_is_pointcepts(counts):
    patch = 16
    m = sum(counts) + 6                          # dummy rows after
    gen = torch.Generator().manual_seed(len(counts))
    order = torch.randperm(sum(counts), generator=gen)
    # Serialized order within each cloud, clouds in order, dummies last.
    starts = np.concatenate([[0], np.cumsum(counts)])
    order = torch.cat([torch.sort(order[(order >= a) & (order < b)]
                                  ).values[torch.randperm(b - a,
                                                          generator=gen)]
                       for a, b in zip(starts[:-1], starts[1:])]
                      + [torch.arange(sum(counts), m)])
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(m)
    lay = patch_layout(order, inverse, torch.tensor(counts), patch)
    pad, unpad, cu = _pointcept_padding(counts, patch)
    total = len(pad)
    assert int(lay.rows) == total
    assert torch.equal(lay.src[:total], order[torch.from_numpy(pad)])
    # Segments: Pointcept's starts with the empty cloud's zero-length one
    # dropped; the unused slots and the end at the padded total.
    got = lay.cu.long().tolist()
    assert sorted(set(got)) == sorted(set(cu.tolist()))
    assert got == sorted(got) and got[-1] == total
    assert len(lay.src) == attention_capacity(m, len(counts), patch)
    real = torch.arange(sum(counts))
    assert torch.equal(lay.dst[order[real]], torch.from_numpy(unpad))


def test_segment_attention_is_per_segment_softmax():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(30, 2, 4, generator=gen) for _ in range(3))
    cu = torch.tensor([0, 16, 21, 25, 25, 25], dtype=torch.int32)
    out = segment_attention(q, k, v, cu, 16)
    for a, b in ((0, 16), (16, 21), (21, 25)):
        w = torch.softmax(torch.einsum("qhd,khd->hqk", q[a:b], k[a:b])
                          * 0.5, -1)
        assert torch.allclose(out[a:b], torch.einsum("hqk,khd->qhd", w,
                                                     v[a:b]), atol=1e-6)
    assert bool((out[25:] == 0).all())


# --- grid sampling, pooling, unpooling --------------------------------------

def test_grid_coordinates_and_sampling_equal_the_reference():
    cfg = _cfg()
    x = _clouds()
    net = PointCloudToWireframe(cfg.model).encoder.backbone
    level, feats, slot, over = net._first_level(x, False, None)
    assert not bool(over)
    m = level.rows
    for b in range(x.shape[0]):
        rows, grid = R.grid_sample(x[b], cfg.model.ptv3_grid_size)
        got = torch.nonzero(slot.reshape(x.shape[0], -1)[b] < m).squeeze(1)
        assert torch.equal(got, rows)
        mine = level.grid[slot.reshape(x.shape[0], -1)[b][rows]]
        assert torch.equal(mine, grid)
        assert torch.equal(feats[slot.reshape(x.shape[0], -1)[b][rows]],
                           x[b, rows])
    assert int(level.counts.sum()) == int(level.valid.sum())


def test_pooling_and_unpooling_against_the_reference():
    cfg = _cfg()
    model, w = _model(cfg)
    net = model.encoder.backbone
    x = _clouds()
    level, feats, slot, _ = net._first_level(x, False, None)
    gen = torch.Generator().manual_seed(5)
    h = torch.randn(level.rows, cfg.model.ptv3_enc_channels[0],
                    generator=gen)
    m1 = capacity_rows(1.0, x.shape[0] * x.shape[1])
    coarse, pooled, over = net._pool(level, h, net.enc[1].pool, m1,
                                     x.shape[0], False, None)
    assert not bool(over)
    p = Precision(torch.float32)
    for b in range(x.shape[0]):
        mine = (level.batch == b) & level.valid
        codes = level.codes[:, mine]
        cluster_code = codes[0] >> 3
        uniq, cluster = torch.unique(cluster_code, return_inverse=True)
        hl = R._lin(p, w, "encoder.backbone.enc.1.pool.proj", h[mine])
        want = hl.new_zeros((len(uniq), hl.shape[1])).scatter_reduce(
            0, cluster[:, None].expand(-1, hl.shape[1]), hl, "amax",
            include_self=False)
        parents = level.parent[mine]
        # The same clusters: rows share a coarse row iff they share a code.
        assert torch.equal(parents[:, None] == parents[None],
                           cluster[:, None] == cluster[None])
        assert torch.equal(pooled[parents], want[cluster])
        assert torch.equal(coarse.grid[parents], level.grid[mine] >> 1)
        assert torch.equal(coarse.codes[:, parents], codes >> 3)
    # Unpooling: BN-GELU(Linear(coarse))[cluster] + BN-GELU(Linear(skip)).
    up = net.dec[0].pool
    c = torch.randn(coarse.rows, up.proj.in_features, generator=gen)
    skip = torch.randn(level.rows, up.proj_skip.in_features, generator=gen)
    got = net._unpool(up, coarse, level, c, skip, False)
    name = "encoder.backbone.dec.0.pool."
    want_c = R._gelu(R._bn(w, name + "bn", R._lin(p, w, name + "proj", c)))
    want = R._gelu(R._bn(w, name + "bn_skip",
                         R._lin(p, w, name + "proj_skip", skip)))
    fine = level.valid
    assert torch.allclose(got[fine], want[fine] + want_c[level.parent[fine]],
                          atol=1e-6)


# --- the whole forward ------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.02)])
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
    assert c["input_rows"] - c["grid_dropped"] == c["rows.stage0"]


def test_planted_fault_is_seen():
    cfg = _cfg("bfloat16")
    _, w = _model(cfg)
    x = _clouds()
    p = Precision(torch.bfloat16)
    m = dataclasses.asdict(cfg.model)
    with torch.no_grad():
        good = R.forward(p, w, m, x)
        bad = R.forward(p, w, m, x, skip_cpe=("enc0.0",))
    assert (good["vertices"] - bad["vertices"]).abs().max() > 0.02


def test_capacity_overflow_raises():
    cfg = _cfg(extra=["model.ptv3_capacity=0.1,1,1,1,1"])
    model, _ = _model(cfg)
    out = make_forward_fn(cfg)(model, _clouds())
    assert bool(out[OVERFLOW])
    with pytest.raises(CapacityOverflow, match="capacity"):
        raise_on_overflow(out)
    assert model.encoder.backbone.counters()["overflow_calls"] == 1


def test_default_capacity_never_overflows():
    cfg = load_config(RECIPE, ["model.encoder=ptv3"])
    assert cfg.model.ptv3_capacity == (1.0,) * 5
    out = make_forward_fn(_cfg())(_model(_cfg())[0], _clouds())
    assert not bool(out[OVERFLOW])
    raise_on_overflow(out)


def test_served_call_after_an_overflow(tmp_path):
    from wireframe_tpu_torch.bridge import (
        save_port_checkpoint,
        state_dict_to_flax,
    )
    from wireframe_tpu_torch.eval.evaluator import make_forward_fn as serve_fn
    from wireframe_tpu_torch.serve import WireframePredictor

    sets = ["model.ptv3_capacity=0.1,1,1,1,1"]
    cfg = _cfg(extra=sets)
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
    pred = WireframePredictor(str(tmp_path), config=RECIPE,
                              overrides=["data.point_buckets=640",
                                         "eval.batch_size=4"],
                              device="cpu")
    assert pred.cfg.model.ptv3_capacity == (0.1, 1.0, 1.0, 1.0, 1.0)
    rng = np.random.default_rng(6)
    big = [corpus.make_building(rng, n_points=n)[0] for n in (600, 600)]
    with pytest.raises(CapacityOverflow):
        pred.predict(big)
    assert len(pred.predict([corpus.make_building(rng, n_points=60)[0]])) \
        == 1


# --- training ---------------------------------------------------------------

def _train_cfg():
    # No weight decay: Adam's first moment is then the clipped gradient's.
    return _cfg(extra=["data.num_points=256", "train.batch_size=2",
                       "model.ptv3_capacity=1,1,1,1,1",
                       "train.weight_decay=0", "train.lr_schedule=constant"])


def test_train_step_reaches_every_backbone_parameter():
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.synth import make_random_batch

    cfg = _train_cfg()
    model, _ = _model(cfg)
    model.train()
    state = create_train_state(cfg, model)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             make_random_batch(cfg, 2).items()}
    gen = torch.Generator().manual_seed(3)
    state, met = make_train_step(cfg)(state, batch, gen)
    assert np.isfinite(float(met["total_loss"]))
    assert np.isfinite(float(met["grad_norm"]))
    names = [k for k in before if k.startswith("encoder.backbone.")]
    assert len(names) > 100
    for k in names:
        assert bool(torch.isfinite(state.mu[k]).all()), k
        assert bool(state.mu[k].abs().sum() > 0), k
        assert not torch.equal(before[k], state.params[k]), k


def test_train_loop_raises_on_an_overflowing_step(tmp_path):
    from wireframe_tpu_torch.train.loop import train_model
    from wireframe_tpu_torch.train.state import create_train_state
    from wireframe_tpu_torch.train.step import make_train_step
    from wireframe_tpu_torch.utils.synth import make_random_batch

    cfg = _cfg(extra=["data.num_points=256", "train.batch_size=2",
                      "model.ptv3_capacity=0.05,1,1,1,1",
                      "train.num_epochs=1", "train.log_every=1",
                      f"train.checkpoint_dir={tmp_path}"])
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             make_random_batch(cfg, 2).items()}
    model, _ = _model(cfg)
    model.train()
    state = create_train_state(cfg, model)
    gen = torch.Generator().manual_seed(3)
    _, met = make_train_step(cfg)(state, batch, gen)
    assert int(met[OVERFLOW]) == 1
    with pytest.raises(CapacityOverflow):
        train_model(cfg, [batch], device="cpu")


def test_batch_norm_statistics_ignore_padding_rows():
    # Without stochastic depth, whose draws are one a packed row and so
    # shift with the capacity the padding rows add.
    cfg = _cfg(extra=["model.ptv3_drop_path=0"])
    x = _clouds(sizes=(100, 220), n=256)
    stats = []
    for pad in (0, 64):
        model, _ = _model(cfg)
        xp = torch.cat([x, torch.zeros(2, pad, 8)], 1)
        gen = torch.Generator().manual_seed(9)
        model.encoder.backbone(xp, train=True, generator=gen)
        stats.append({k: v.clone() for k, v in
                      model.encoder.backbone.state_dict().items()
                      if "running" in k})
    for k in stats[0]:
        assert torch.allclose(stats[0][k], stats[1][k], atol=1e-6), k


# --- checkpoints, serving, config ------------------------------------------

def test_checkpoint_round_trip_and_serving(tmp_path):
    from wireframe_tpu_torch.bridge import (
        params_from_flax,
        save_port_checkpoint,
        state_dict_to_flax,
    )
    from wireframe_tpu_torch.serve import WireframePredictor

    cfg = _cfg(extra=["data.point_buckets=640", "eval.batch_size=2"])
    model, _ = _model(cfg)
    flat = state_dict_to_flax(model.state_dict(), cfg.model)
    back = params_from_flax(flat)
    sd = model.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k].float()) for k in sd)
    save_port_checkpoint(str(tmp_path), flat, cfg)
    pred = WireframePredictor(str(tmp_path), config=RECIPE,
                              overrides=["data.point_buckets=640",
                                         "eval.batch_size=2"],
                              device="cpu")
    assert pred.cfg.model.encoder == "ptv3"
    rng = np.random.default_rng(4)
    clouds = [corpus.make_building(rng, n_points=n)[0] for n in (200, 500)]
    out = pred.predict(clouds)
    assert len(out) == 2


def test_config_keys():
    plain = config_to_dict(load_config(RECIPE))
    assert "encoder" not in plain["model"]
    assert not any(k.startswith("ptv3_") for k in plain["model"])
    cfg = _cfg()
    tree = config_to_dict(cfg)
    assert tree["model"]["encoder"] == "ptv3"
    assert tree["model"]["ptv3_patch_size"] == 16
    assert not any(k in tree["model"] for k in (
        "ptv3_order", "ptv3_stride", "ptv3_mlp_ratio", "ptv3_qkv_bias"))
    net = PTv3Backbone()
    assert net.out_channels == 64 and len(net.enc) == 5 and len(net.dec) == 4
    assert [len(s.blocks) for s in net.enc] == [2, 2, 2, 6, 2]


def test_checkpoint_metadata_warns_only_for_missing_ptv3_keys(caplog):
    from wireframe_tpu_torch.train.checkpoint import (
        apply_checkpoint_model_config,
    )

    tree = config_to_dict(load_config(RECIPE))
    with caplog.at_level("WARNING"):
        cfg = apply_checkpoint_model_config(load_config(None),
                                            {"config": tree})
    assert cfg.model.encoder == "pointnet" and not caplog.records
    tree = config_to_dict(_cfg())
    del tree["model"]["ptv3_patch_size"]
    with caplog.at_level("WARNING"):
        cfg = apply_checkpoint_model_config(load_config(None),
                                            {"config": tree})
    assert cfg.model.encoder == "ptv3"
    assert "ptv3_patch_size" in caplog.text
