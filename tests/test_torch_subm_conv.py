"""PTv3's submanifold convolution (`ops.subm_conv`), the CPU half.

The kernel (`csrc/subm_conv.cu`) runs only on the card (`python3
chip_smoke.py`, phase "ptv3": the 23 convolutions of a (128, 16384) call
against the plain version).  Here:

- `subm_conv_plain` against the benchmark's plain reference
  (`port_bench/reference/ptv3.py`'s `subm_conv`) at every (K, CIN, COUT)
  the published configuration runs, in float32 and bfloat16;
- rows with no neighbour (their map rows all M, the zero row), dummy
  rows among them, give the bias;
- the dispatch rule (`engages`): a CPU tensor, autograd on, float32 or a
  (CIN, COUT, K) outside the kernel's plan take the plain version, shown
  on the backbone with the op stubbed to raise; the backbone's step
  counters stay at zero there;
- the wrapper refuses widths, offsets and dtypes the kernel does not take,
  with no card;
- the launch plan at the cell's shapes;
- `ptv3_conv_roofline_pct.infer`'s arithmetic on a fake profiled
  segment, and None where the kernel never ran.
"""

import os

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import ptv3 as R
from port_bench.reference.model import Precision
from port_bench.trace import Segment
from wireframe_tpu_torch.models.ptv3 import PTv3Backbone
from wireframe_tpu_torch.ops import subm_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ptv3-infer-b128-16k"
METRIC = "ptv3_conv_roofline_pct.infer"
H100 = "NVIDIA H100 80GB HBM3"
# (K, CIN, COUT) of every convolution the published configuration runs:
# the stem (size 5) and the xCPE convs (size 3) at each stage's width.
CONVS = [(125, 8, 32), (27, 32, 32), (27, 64, 64), (27, 128, 128),
         (27, 256, 256), (27, 512, 512)]
SIZE = {125: 5, 27: 3}


def _level(seed, n=160, box=7):
    """n distinct voxels in a box^3 grid, their map at `size`."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(box ** 3, size=n, replace=False)
    grid = np.stack([cells // box ** 2, cells // box % box, cells % box], 1)
    return torch.from_numpy(grid).long()


def _conv(k, cin, cout, seed, bias=True):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((cout, k * cin), generator=gen) / (k * cin) ** 0.5
    b = 0.1 * torch.randn((cout,), generator=gen) if bias else None
    return w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,cin,cout", CONVS)
def test_plain_is_the_reference_conv(k, cin, cout, dtype):
    grid = _level(k + cin)
    nbr = R.neighbours(grid, SIZE[k])
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn((grid.shape[0], cin), generator=gen)
    w, b = _conv(k, cin, cout, seed=cin, bias=k == 27)
    params = {"c.weight": w}
    if b is not None:
        params["c.bias"] = b
    want = R.subm_conv(Precision(dtype), params, "c", x, nbr)
    got = subm_conv.subm_conv_plain(x, nbr, w, b, dtype=dtype)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    # The same operands, products and bias in the same dtype: apart at most
    # by the sums' order, within one unit in the last place of the largest.
    ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7
    gap = float((got.float() - want.float()).abs().max())
    assert gap <= 4 * ulp * float(want.float().abs().max()), gap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_rows_with_no_neighbour_give_the_bias(bias, dtype):
    """Real rows whose map names only M (no voxel within reach) and the
    dummy rows past the level's count (M everywhere, as the packed levels
    sort them last) come out as the bias, or zero without one."""
    k, cin, cout = 27, 32, 32
    grid = _level(5, n=40, box=9)
    nbr = R.neighbours(grid, 3)
    m = 48
    nbr = torch.where(nbr == grid.shape[0], m, nbr)
    lonely = torch.tensor([3, 17])
    nbr[lonely] = m
    nbr = torch.cat([nbr, torch.full((m - grid.shape[0], k), m)])
    x = torch.randn((m, cin), generator=torch.Generator().manual_seed(2))
    w, b = _conv(k, cin, cout, seed=4, bias=bias)
    got = subm_conv.subm_conv_plain(x, nbr, w, b, dtype=dtype)
    empty = torch.cat([lonely, torch.arange(grid.shape[0], m)])
    want = (b.to(dtype) if bias else torch.zeros(cout, dtype=dtype)
            ).expand(len(empty), cout)
    assert torch.equal(got[empty], want)
    rest = torch.ones(m, dtype=torch.bool)
    rest[empty] = False
    assert bool((got[rest].float().abs().sum(1) > 0).all())


# (device, dtype, autograd on, CIN, COUT, K) -> the kernel?
RULE = [("cuda", torch.bfloat16, False, 32, 32, 27, True),
        ("cuda", torch.bfloat16, False, 8, 32, 125, True),
        ("cuda", torch.bfloat16, True, 32, 32, 27, False),
        ("cuda", torch.float32, False, 32, 32, 27, False),
        ("cuda", torch.bfloat16, False, 16, 16, 27, False),
        ("cuda", torch.bfloat16, False, 64, 128, 27, False),
        ("cuda", torch.bfloat16, False, 32, 32, 343, False),
        ("cpu", torch.bfloat16, False, 32, 32, 27, False),
        ("cpu", torch.float32, True, 32, 32, 27, False)]


@pytest.mark.parametrize("case", RULE)
def test_dispatch_rule(case):
    device, dtype, grad, cin, cout, k, kernel = case
    assert subm_conv.engages(torch.device(device), dtype, grad, cin, cout,
                             k) is kernel


class _Reached(Exception):
    pass


def _stub(*args, **kwargs):
    raise _Reached


def _backbone(dtype, width=None):
    """A small backbone; with `width`, every stage that wide."""
    torch.manual_seed(0)
    enc, dec = (8, 16, 16, 32, 32), (16, 16, 16, 32)
    if width:
        enc, dec = (width,) * 5, (width,) * 4
    return PTv3Backbone(in_channels=8, enc_channels=enc,
                        enc_num_head=(1, 2, 2, 4, 4),
                        dec_channels=dec,
                        dec_num_head=(2, 2, 2, 4), patch_size=16,
                        grid_size=0.08, dtype=dtype).eval()


def _clouds():
    rng = np.random.default_rng(3)
    x = np.zeros((2, 96, 8), np.float32)
    x[0, :80] = rng.uniform(-1, 1, (80, 8))
    x[1, :50] = rng.uniform(-1, 1, (50, 8))
    return torch.from_numpy(x)


@pytest.mark.parametrize("mode", ["autograd on", "f32", "cpu", "width",
                                  "kernel"])
def test_backbone_takes_plain_path(mode, monkeypatch):
    """With the op stubbed to raise, every path that must stay plain runs,
    and the kernel's step counters stay at zero; where the rule says kernel
    (forced for a CPU tensor here), the stub is reached.  "width": the rule
    itself, shown a CUDA device, on a backbone whose every conv has a
    (CIN, COUT) outside `SHAPES`."""
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    net = _backbone(dtype, 16 if mode == "width" else None)
    monkeypatch.setattr(subm_conv, "subm_conv", _stub)
    if mode == "width":
        rule = subm_conv.engages
        monkeypatch.setattr(subm_conv, "engages", lambda d, *a: rule(
            torch.device("cuda"), *a))
    if mode == "kernel":
        monkeypatch.setattr(subm_conv, "engages", lambda *a: True)
        with torch.no_grad(), pytest.raises(_Reached):
            net(_clouds())
        return
    with torch.set_grad_enabled(mode == "autograd on"):
        feats, _, _, _ = net(_clouds())
    assert bool(torch.isfinite(feats).all())
    c = net.counters()
    assert c["conv_steps_run"] == c["conv_steps_skipped"] == 0
    assert c["conv_pairs.stem"] > 0


@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 128), (32, 64),
                                      (8, 64)])
def test_wrapper_refuses_other_widths(cin, cout):
    m = 64
    x = torch.zeros((m, cin))
    nbr = torch.zeros((m, 27), dtype=torch.long)
    w = torch.zeros((cout, 27 * cin))
    with pytest.raises(ValueError, match="built for"):
        subm_conv._launch(x, nbr, w, None, dtype=torch.bfloat16)


@pytest.mark.parametrize("what", ["offsets", "dtype", "map dtype",
                                  "weight", "counters"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    m, k, cin, cout = 64, 27, 32, 32
    kw = {"dtype": torch.bfloat16}
    x = torch.zeros((m, cin))
    nbr = torch.zeros((m, k), dtype=torch.long)
    w = torch.zeros((cout, k * cin))
    if what == "offsets":
        nbr = torch.zeros((m, 343), dtype=torch.long)
        w = torch.zeros((cout, 343 * cin))
    elif what == "dtype":
        kw["dtype"] = torch.float32
    elif what == "map dtype":
        nbr = nbr.int()
    elif what == "weight":
        w = torch.zeros((cout, k * cin + 8))
    else:
        kw["counters"] = torch.zeros(3, dtype=torch.long)
    with pytest.raises(ValueError):
        subm_conv._launch(x, nbr, w, None, **kw)


# (M, K, CIN, COUT) at the cell's capacities -> (row tiles, column tiles,
# chunks of a tile that uses every offset).
PLANS = {(608176, 125, 8, 32): (4752, 1, 63),
         (608176, 27, 32, 32): (4752, 1, 27),
         (608176, 27, 64, 64): (4752, 1, 27),
         (54528, 27, 128, 128): (852, 1, 54),
         (14056, 27, 256, 256): (220, 2, 108),
         (3992, 27, 512, 512): (63, 4, 216)}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan(shape):
    plan = subm_conv.subm_conv_plan(*shape)
    rows, cols, chunks = PLANS[shape]
    assert (plan["row_tiles"], plan["col_tiles"], plan["chunks"]) == (
        rows, cols, chunks)
    assert plan["blocks"] == rows * cols >= 132
    assert plan["bm"] * plan["row_tiles"] >= shape[0]


# The counters of a window of two calls at the cell's capacities.
PAIRS = {"stem": 12804834, "stage0": 4648420, "stage1": 1736429,
         "stage2": 409582, "stage3": 89782, "stage4": 19198}
ROWS = [608176, 203424, 54528, 14056, 3992]


def _reading(device=((0.0, 0.0015), (0.002, 0.004)), units=2,
             device_name=H100, counters=True):
    cell = harness.load_cell(ROOT, CELL)
    name = ("void (anonymous namespace)::subm_conv_kernel<64, 128, 64, 64, "
            "4>((anonymous namespace)::Params)")
    seg = Segment(device=[(name, a, b) for a, b in device]
                  + [("void at::native::vectorized_elementwise_kernel", 0.0,
                      1.0)], start=0.0, end=1.0, units=units)
    window = {"segment_units": units,
              "ptv3_capacity_rows": ROWS if counters else None,
              "ptv3_counters": ({"calls": 2, **{f"conv_pairs.{k}": 2 * v
                                                for k, v in PAIRS.items()}}
                                if counters else None)}
    return harness.Reading(cell=cell, device_name=device_name,
                           window=window, spans=None, segment=seg)


def test_conv_roofline_metric_arithmetic():
    """The least time of a call's 23 convolutions, written out here, over
    the kernel's 1.75 ms a call (3.5 ms over 2 calls)."""
    read = harness.metric_module(ROOT, METRIC).read
    # (level rows, K, CIN, COUT, bias, pairs) of each conv of a forward.
    convs = [(ROWS[0], 125, 8, 32, 0, PAIRS["stem"])]
    for s, (c_enc, d_enc, c_dec, d_dec) in enumerate(
            [(32, 2, 64, 2), (64, 2, 64, 2), (128, 2, 128, 2),
             (256, 6, 256, 2), (512, 2, 0, 0)]):
        convs += [(ROWS[s], 27, c_enc, c_enc, 1, PAIRS[f"stage{s}"])] * d_enc
        convs += [(ROWS[s], 27, c_dec, c_dec, 1, PAIRS[f"stage{s}"])] * d_dec
    assert len(convs) == 23
    flops = sum(2.0 * p * ci * co for _, _, ci, co, _, p in convs)
    nbytes = sum(2 * m * ci + 4 * m * k + 2 * k * ci * co + 2 * co * b
                 + 2 * m * co for m, k, ci, co, b, _ in convs)
    least = max(flops / 989.4e12, nbytes / 3.35e12)
    assert read(_reading()) == pytest.approx(100.0 * least / 1.75e-3,
                                             rel=1e-12)
    assert 0 < read(_reading()) < 100


@pytest.mark.parametrize("case", ["kernel never ran", "cpu", "no segment",
                                  "no counters"])
def test_conv_roofline_metric_is_none(case):
    read = harness.metric_module(ROOT, METRIC).read
    r = _reading(device=() if case == "kernel never ran" else
                 ((0.0, 0.001),), device_name="cpu" if case == "cpu"
                 else H100, counters=case != "no counters")
    if case == "no segment":
        r.segment = None
    assert read(r) is None
