"""K5's recomputing backward by row chunks (`ops.chain_grad.remat_plan`).

The JAX package's remat backward recomputes each tile's activations in
VMEM and holds nothing else; the port recomputes chunk by chunk of rows,
so what one K5 backward call holds is about `REMAT_CHUNK_BYTES` beside
the seed and the gradients, whatever the batch.  The plan is pure, so it
is tested here: chunks cover every row once, in order, on whole 128-row
tiles; every shape of the shipped encoder up to (8, 2560) is one chunk in
both dtypes, with the dW K-slices of one whole-batch pass; the bench's
(128, 2560) and 64 clouds of 16384 points stay under the cap.

The plain backward runs the same plan (`chain_backward_plain(...,
plan=...)`): per chunk the recompute and stage backward of its rows, the
LayerNorm / bias column sums per 128-row tile added on in tile order,
each dW's K-slices added on in slice order.  With the cap forced low
(four chunks, the last one shorter) it is held to the JAX remat kernel
(`make_differentiable_chain(backward="remat", interpret=True)`) at
tests/test_torch_chain_grad.py's tolerances (see TOL); to itself in one chunk (dx
and the LayerNorm / bias gradients array_equal, as the card's chunks keep
the same row tiles); and to the whole-batch plain backward (dx
array_equal, every other gradient within f32 rounding: only the order of
its sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.ops.pallas_chain_grad import make_differentiable_chain
from wireframe_tpu_torch.ops import chain_grad
from wireframe_tpu_torch.ops._launch import launch_counts
from wireframe_tpu_torch.ops.chain_grad import (
    REMAT_CHUNK_BYTES,
    REMAT_MIN_ROWS,
    chain_backward_plain,
    remat_chain_backward,
    remat_chain_forward,
    remat_plan,
)
from wireframe_tpu_torch.ops.hopper_gemm import BM, chain_plan

FULL = (512, 1024, 2048, 1024)
WIDE = (512, 1024, 4096, 1024)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# The shipped encoder's shapes that must stay one whole-batch pass:
# (B, N) of the parity model, the recipe's remat steps, the layouts'
# remat step and the f32 phase (all at most 8 x 2560), ragged ones.
ONE_PASS = {"parity (3, 2560)": (3 * 2560, 8, FULL, 512),
            "recipe (8, 2560)": (8 * 2560, 8, FULL, 512),
            "ragged cluster": (2 * 328, 8, (600, 1100), 300),
            "ragged": (2 * 200, 8, (40, 72), 36)}
LARGE = {"bench (128, 2560)": (128 * 2560, 8, FULL, 512),
         "64 x 16384": (64 * 16384, 8, FULL, 512)}
FORCED = dict(chunk_bytes=1, min_rows=BM)
# tests/test_torch_chain_grad.py's tolerances: in f32 the JAX tests'
# own; in bf16 the JAX bf16 test's 5e-2 for the gradients.  That file
# holds its bf16 remat chain to 1e-3 at (3, 64); at (3, 160) the
# whole-batch plain backward itself lies 1.65x outside 1e-3 of the JAX
# kernel on one element of dW0 (and the chunked one, 6e-5 from it, with
# it): one bf16 rounding of a recomputed h goes the other way.  The
# chunked backward is held to the whole-batch one far tighter below.
TOL = {"float32": dict(fwd=dict(rtol=1e-5, atol=1e-5),
                       grad=dict(rtol=1e-3, atol=2e-4)),
       "bfloat16": dict(fwd=dict(rtol=1e-4, atol=1e-4),
                        grad=dict(rtol=5e-2, atol=5e-2))}
FLAVOURS = {"features": (0, True), "kv": (4, True), "kv_slim": (4, False)}
B, N = 3, 160           # 480 rows: chunks of 128, 128, 128 and 96


def _covers(chunks, m, rows):
    assert chunks[0][0] == 0 and chunks[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(b - a == rows for a, b in chunks[:-1])
    assert 0 < chunks[-1][1] - chunks[-1][0] <= rows
    assert len(chunks) == 1 or rows % BM == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(ONE_PASS))
def test_shapes_up_to_8_x_2560_run_one_chunk(name, dtype):
    m, d, widths, out = ONE_PASS[name]
    plan = remat_plan(m, d, widths, out, DTYPES[dtype])
    assert plan["chunks"] == [(0, m)]
    assert plan["chunk_rows"] == m
    assert plan["dw_slices"] == [
        chain_plan(m, d, widths, out, DTYPES[dtype])["dw_slices"]]
    assert plan["chunk_peak"] <= REMAT_CHUNK_BYTES


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(LARGE))
def test_large_batches_stay_under_the_cap(name, dtype):
    """Chunks of whole row tiles under REMAT_CHUNK_BYTES, at least
    REMAT_MIN_ROWS rows; the call's peak is the chunk's beside what lives
    through it, far under the whole batch's recomputed z and h."""
    m, d, widths, out = LARGE[name]
    esize = 4 if dtype == "f32" else 2
    plan = remat_plan(m, d, widths, out, DTYPES[dtype])
    rows = plan["chunk_rows"]
    _covers(plan["chunks"], m, rows)
    assert REMAT_MIN_ROWS <= rows < m
    assert plan["chunk_peak"] <= REMAT_CHUNK_BYTES
    # The next row tile would not fit.
    bigger = remat_plan(m, d, widths, out, DTYPES[dtype],
                        chunk_bytes=REMAT_CHUNK_BYTES + 1)
    assert bigger["chunk_rows"] == rows
    assert plan["whole_batch_bytes"] == m * sum(widths) * (4 + esize)
    # Beside the chunk: the seed (m x 512 in the compute dtype) and x,
    # dx, the gradients; far from the whole batch's transient.
    seed = m * 512 * esize
    assert plan["peak_bytes"] - plan["chunk_peak"] >= seed
    assert plan["peak_bytes"] - plan["chunk_peak"] <= seed + 64 * m + 2e8
    assert plan["peak_bytes"] < plan["whole_batch_bytes"] / 5
    for (a, b), slices in zip(plan["chunks"], plan["dw_slices"]):
        assert [s[-1][1] for s in slices] == [b - a] * (len(widths) + 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_peak_is_monotone_in_the_cap(dtype):
    m, d, widths, out = LARGE["bench (128, 2560)"]
    caps = [1, 2 ** 26, 2 ** 28, 2 ** 29, 2 ** 30, 2 ** 31, 2 ** 33, 2 ** 40]
    plans = [remat_plan(m, d, widths, out, DTYPES[dtype], chunk_bytes=c,
                        min_rows=BM) for c in caps]
    peaks = [p["peak_bytes"] for p in plans]
    rows = [p["chunk_rows"] for p in plans]
    assert peaks == sorted(peaks) and rows == sorted(rows)
    assert rows[0] == BM and plans[-1]["chunks"] == [(0, m)]
    for c, p in zip(caps[1:], plans[1:]):
        assert p["chunk_peak"] <= c


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [100003, 20481, 129])
def test_ragged_rows_and_a_split_stage_are_planned(m, dtype):
    """A ragged m and a 4096-wide (split) stage: whole row tiles but the
    last, the split stage's f32 dh counted, the floor kept."""
    plan = remat_plan(m, 8, WIDE, 512, DTYPES[dtype])
    rows = plan["chunk_rows"]
    _covers(plan["chunks"], m, rows)
    assert rows == m or rows >= REMAT_MIN_ROWS
    forced = remat_plan(m, 8, WIDE, 512, DTYPES[dtype], chunk_bytes=2 ** 27,
                        min_rows=BM)
    _covers(forced["chunks"], m, forced["chunk_rows"])
    assert forced["chunk_peak"] <= 2 ** 27 or forced["chunk_rows"] == BM
    fused = remat_plan(m, 8, (512, 1024, 2048, 1024), 512, DTYPES[dtype],
                       chunk_bytes=2 ** 27, min_rows=BM)
    # The split stage's f32 dh makes a row dearer than a fused one's.
    assert forced["chunk_rows"] <= fused["chunk_rows"]


def test_the_floor_keeps_every_sm_busy():
    """However wide the chain, a chunk has at least REMAT_MIN_ROWS rows:
    132 row tiles, one for each SM in every stage GEMM."""
    assert REMAT_MIN_ROWS == 132 * BM
    plan = remat_plan(10 ** 6, 8, (8192, 16384, 8192), 2048, torch.float32)
    assert plan["chunk_rows"] == REMAT_MIN_ROWS
    _covers(plan["chunks"], 10 ** 6, REMAT_MIN_ROWS)


# ---------------------------------------------------------------------------
# The chunked plain backward
# ---------------------------------------------------------------------------

def _params(seed, d=8, dims=(16, 32), c=24):
    rng = np.random.default_rng(seed)
    prev, sp = d, []
    for h in dims:
        sp.append(tuple(a.astype(np.float32) for a in (
            rng.normal(size=(prev, h)) / np.sqrt(prev),
            rng.normal(size=h) * 0.1, 1.0 + rng.normal(size=h) * 0.1,
            rng.normal(size=h) * 0.1)))
        prev = h
    fw = (rng.normal(size=(prev, c)) / np.sqrt(prev)).astype(np.float32)
    fb = (rng.normal(size=c) * 0.1).astype(np.float32)
    return sp, fw, fb


def _cloud(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, 8)).astype(np.float32)
    x[0, 100:] = 0.0           # padding tail, across a chunk edge
    x[1, 124:132] = 0.0        # fully invalid windows on a chunk edge
    x[1, 17] = x[1, 16]        # duplicated rows: exact ties in a window
    x[2] = 0.0                 # an all-padding sample
    return x


def _weights(shapes, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _jax_grads(x, sp, fw, fb, kv_pool, emit, dtype):
    chain = make_differentiable_chain(
        tile=32, compute_dtype=getattr(jnp, dtype), interpret=True,
        backward="remat", kv_pool=kv_pool, emit_features=emit)
    args = (jnp.asarray(x), tuple(tuple(map(jnp.asarray, s)) for s in sp),
            jnp.asarray(fw), jnp.asarray(fb))
    outs = chain(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ws = [jnp.asarray(w) for w in _weights([o.shape for o in outs])]

    def loss(*a):
        o = chain(*a)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(v * w) + 0.1 * jnp.sum(v ** 2)
                   for v, w in zip(o, ws))

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(o) for o in outs], [np.asarray(t) for t in [
        g[0], *[t for s in g[1] for t in s], g[2], g[3]]]


def _torch_case(x, sp, fw, fb, kv_pool, emit, dtype):
    """The port's remat forward and the cotangents of the same loss:
    (outputs, the backward's arguments)."""
    xt = torch.from_numpy(x)
    stages = [tuple(torch.from_numpy(a) for a in s) for s in sp]
    fwt, fbt = torch.from_numpy(fw), torch.from_numpy(fb)
    cdt = getattr(torch, dtype)
    res = remat_chain_forward(xt, stages, fwt, fbt, kv_pool=kv_pool,
                              emit_features=emit, compute_dtype=cdt)
    outs = ([res["features"]] if emit else []) + (
        [res["pooled"], res["sums"]] if kv_pool else [])
    ws = [torch.from_numpy(w)
          for w in _weights([tuple(o.shape) for o in outs])]
    cots = [w + 0.2 * o for o, w in zip(outs, ws)]   # d loss / d output
    kw = dict(kv_pool=kv_pool, compute_dtype=cdt)
    if emit:
        kw["g"] = cots[0]
    if kv_pool:
        kw.update(dpool=cots[-2], dsums=cots[-1], idx=res["idx"])
    return outs, (xt, stages, fwt, fbt), kw


def _flat(r):
    return [r[0], *[t for st in r[1] for t in st], r[2], r[3]]


# Positions in `_flat`'s order: dx, then (dW, db, d gamma, d beta) per
# stage, then dW and db of the projection.
DW = {1, 5, 9}


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_plain_backward_matches_jax_remat(flavour, dtype,
                                                  monkeypatch):
    from test_torch_chain_grad import no_kernel_library

    kv_pool, emit = FLAVOURS[flavour]
    sp, fw, fb = _params(1)
    x = _cloud(2)
    want_o, want_g = _jax_grads(x, sp, fw, fb, kv_pool, emit, dtype)
    outs, args, kw = _torch_case(x, sp, fw, fb, kv_pool, emit, dtype)
    plan = remat_plan(B * N, 8, (16, 32), 24, kw["compute_dtype"], **FORCED)
    assert plan["chunks"] == [(0, 128), (128, 256), (256, 384), (384, 480)]
    no_kernel_library(monkeypatch)
    counts = launch_counts()
    got = _flat(remat_chain_backward(*args, **kw, **FORCED))
    assert launch_counts() == counts
    tol = TOL[dtype]
    for o, w in zip(outs, want_o):
        np.testing.assert_allclose(o.numpy(), w, **tol["fwd"])
    assert len(got) == len(want_g)
    for i, (g, w) in enumerate(zip(got, want_g)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"gradient {i}",
                                   **tol["grad"])


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunks_against_one_chunk_and_the_whole_batch(flavour, dtype):
    kv_pool, emit = FLAVOURS[flavour]
    sp, fw, fb = _params(3)
    _, args, kw = _torch_case(_cloud(4), sp, fw, fb, kv_pool, emit, dtype)
    many = _flat(chain_backward_plain(*args, None, **kw, plan=remat_plan(
        B * N, 8, (16, 32), 24, kw["compute_dtype"], **FORCED)))
    one_plan = remat_plan(B * N, 8, (16, 32), 24, kw["compute_dtype"])
    assert len(one_plan["chunks"]) == 1
    one = _flat(chain_backward_plain(*args, None, **kw, plan=one_plan))
    whole = _flat(chain_backward_plain(*args, None, **kw))
    # The CPU wrapper's default is the whole batch.
    assert all(torch.equal(a, b) for a, b in zip(
        _flat(remat_chain_backward(*args, **kw)), whole))
    for i, (a, b, w) in enumerate(zip(many, one, whole)):
        scale = float(w.abs().max())
        if i in DW:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6 * scale, err_msg=str(i))
        else:
            assert torch.equal(a, b), i
        if i in (0, 10):        # dx (row by row), d final_b (the seed)
            assert torch.equal(a, w), i
        else:
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6 * scale, err_msg=str(i))


def test_no_dx_and_the_stash_refuses_a_plan():
    sp, fw, fb = _params(3)
    _, args, kw = _torch_case(_cloud(4), sp, fw, fb, 4, True, "float32")
    plan = remat_plan(B * N, 8, (16, 32), 24, torch.float32, **FORCED)
    full = chain_backward_plain(*args, None, **kw, plan=plan)
    part = chain_backward_plain(*args, None, **kw, plan=plan, need_dx=False)
    assert part[0] is None
    assert all(torch.equal(a, b) for a, b in zip(_flat(full)[1:],
                                                 _flat(part)[1:]))
    zs = [torch.zeros(B, N, w) for w in (16, 32)]
    with pytest.raises(ValueError, match="remat plan"):
        chain_backward_plain(*args, zs, **kw, plan=plan)


def test_the_cap_is_read_at_the_call(monkeypatch):
    """The module's REMAT_CHUNK_BYTES / REMAT_MIN_ROWS stand in for
    keywords left None, read at the call, so a caller can set them for a
    whole training run; the CPU wrapper plans once either is given."""
    sp, fw, fb = _params(3)
    _, args, kw = _torch_case(_cloud(4), sp, fw, fb, 0, True, "float32")
    seen = []
    real = chain_grad.remat_plan

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)

    monkeypatch.setattr(chain_grad, "remat_plan", spy)
    remat_chain_backward(*args, **kw, min_rows=BM)
    assert seen == [dict(chunk_bytes=None, min_rows=BM)]
    m, widths = B * N, (16, 32)
    monkeypatch.setattr(chain_grad, "REMAT_CHUNK_BYTES", 1)
    monkeypatch.setattr(chain_grad, "REMAT_MIN_ROWS", 256)
    assert real(m, 8, widths, 24)["chunks"] == [(0, 256), (256, m)]
    assert real(m, 8, widths, 24, min_rows=BM)["chunk_rows"] == BM
    monkeypatch.setattr(chain_grad, "REMAT_CHUNK_BYTES", 1 << 40)
    assert real(m, 8, widths, 24)["chunks"] == [(0, m)]
