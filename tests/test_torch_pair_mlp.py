"""The edge head's pair MLP (`ops.pair_mlp`), the CPU half.

The kernel (`csrc/pair_mlp.cu`) runs only on the card (`python3
chip_smoke.py`, phase "pair MLP").  Here:

- `pair_mlp_plain` against the edge head's eager tail as it was written
  before the op existed (the same ops, so bit for bit, dropout included),
  and the port's `EdgePredictor`, which runs it on the CPU, against the
  JAX package's edge head through the bridge;
- `pair_mlp_plan`: shared memory within the 227 KB a block may have,
  ragged last tiles, more tiles than SMs at the bulk batch;
- `pack_weights`' vector against the kernel's layout;
- the dispatch rule (`engages`): autograd on, f32, dropout (train), a
  CPU tensor or a width or slot count outside the kernel's plan each take
  the eager path, shown with the op stubbed to raise;
- a non-CPU call on a host without the library raises instead of falling
  back to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.models.edge_head import EdgePredictor as JaxEdgePredictor
from wireframe_tpu_torch.bridge import flatten_params, params_from_flax
from wireframe_tpu_torch.models.edge_head import EdgePredictor
from wireframe_tpu_torch.models.layers import dropout, gelu
from wireframe_tpu_torch.ops import _build, pair_mlp
from wireframe_tpu_torch.ops.pairs import triu_pairs_on

F, HEADS, SLOT = 64, 4, 8


def _head(dtype, v, seed=0, rate=0.1, f=F):
    """A port EdgePredictor of width f with every bias and LayerNorm term
    off the init's zeros and ones, and its inputs."""
    torch.manual_seed(seed)
    m = EdgePredictor(hidden_dim=f, num_heads=HEADS, slot_feature_dim=SLOT,
                      dtype=dtype, attn_dropout=rate, mlp_dropout=rate)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias") or name.startswith("LayerNorm"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    b = 3
    verts = torch.randn((b, v, 3), generator=gen)
    feats = torch.randn((b, v, SLOT), generator=gen)
    live = torch.rand((b, v), generator=gen) > 0.3
    return m, verts, feats, live


def _eager_tail(m, x, u_i, u_j, slot_mask, train, gen):
    """The edge head's lines from the pair sum on, as they stood before
    `ops/pair_mlp.py` (PairDense's sum, then the modules)."""
    pairs = triu_pairs_on(x.shape[1], x.device)
    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    c1 = x[:, i_idx, :]
    c2 = x[:, j_idx, :]
    d2 = torch.sum(torch.square(c1 - c2), dim=-1, keepdim=True)
    dist = torch.sqrt(d2 + 1e-12)
    k = m.Dense_2.kernel.to(m.dtype)
    y = (u_i[:, i_idx] + u_j[:, j_idx] + dist.to(m.dtype) * k[2 * F + 6]
         + m.Dense_2.bias.to(m.dtype))
    y = gelu(m.LayerNorm_2(y))
    y = dropout(y, m.mlp_dropout, train, gen)
    y = gelu(m.LayerNorm_3(m.Dense_3(y)))
    y = dropout(y, m.mlp_dropout, train, gen)
    y = gelu(m.Dense_4(y))
    logits = m.Dense_5(y)[..., 0].float()
    pair_mask = slot_mask[:, i_idx] & slot_mask[:, j_idx]
    probs = torch.sigmoid(logits) * pair_mask.float()
    return probs, logits, pair_mask


@pytest.mark.parametrize("v", [3, 8, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("train", [False, True])
def test_plain_is_the_eager_tail(v, dtype, train):
    m, verts, feats, live = _head(dtype, v)
    with torch.no_grad():
        x, u_i, u_j = m.slot_rows(verts, live, feats)
        got = pair_mlp.pair_mlp_plain(
            u_i, u_j, x, live, m.pair_params(), dtype=dtype,
            rate=m.mlp_dropout, train=train,
            generator=torch.Generator().manual_seed(5))
        want = _eager_tail(m, x, u_i, u_j, live, train,
                           torch.Generator().manual_seed(5))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def _flax_head(v, dtype, seed=3):
    """(flax module, its params with biases and LayerNorm terms moved off
    the init, the port's EdgePredictor holding the same weights, inputs)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = JaxEdgePredictor(vertex_dim=3, hidden_dim=F, num_heads=HEADS,
                          max_vertices=v, dtype=jdt)
    rng = np.random.default_rng(seed)
    b = 3
    verts = rng.normal(size=(b, v, 3)).astype(np.float32)
    feats = rng.normal(size=(b, v, SLOT)).astype(np.float32)
    live = rng.random((b, v)) > 0.3
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(verts),
                     jnp.asarray(live), True, jnp.ones((b, v), bool),
                     jnp.asarray(feats))["params"]
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params),
                          "edge_predictor")
    for k, x in flat.items():
        if k.endswith(("bias", "scale")):
            flat[k] = (x + rng.normal(size=x.shape) * 0.1).astype(np.float32)
    tm = EdgePredictor(hidden_dim=F, num_heads=HEADS, slot_feature_dim=SLOT,
                       dtype=dtype)
    prefix = "edge_predictor."
    tm.load_state_dict({k[len(prefix):]: t for k, t in
                        params_from_flax(flat).items()}, strict=True)
    tree = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")[1:]
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(x)
    return jm, tree, tm, verts, feats, live


# f32: float noise (as tests/test_torch_model.py); bf16: the two round at
# the same places in different summation orders: up to 2 bf16 ulps of a
# logit of magnitude ~2 (1.6e-2) and 3.6e-3 of a probability were seen.
TOL = {torch.float32: {"probs": 2e-5, "logits": 5e-5},
       torch.bfloat16: {"probs": 1e-2, "logits": 3e-2}}


@pytest.mark.parametrize("v", [3, 8, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_edge_head_matches_flax(v, dtype):
    jm, tree, tm, verts, feats, live = _flax_head(v, dtype)
    attn = np.ones_like(live)
    want = jm.apply({"params": tree}, jnp.asarray(verts), jnp.asarray(live),
                    True, jnp.asarray(attn), jnp.asarray(feats))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(verts), torch.from_numpy(live),
                        attn_slot_mask=torch.from_numpy(attn),
                        slot_features=torch.from_numpy(feats))
    for name, g, w in zip(("probs", "logits"), got[:2], want[:2]):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=TOL[dtype][name], err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# (B, V, F) -> (tiles, grid, last tile's rows)
PLANS = {(512, 40, 512): (3120, 132, 128),      # the bulk inference batch
         (128, 64, 512): (2016, 132, 128),      # the parity model's slots
         (3, 40, 512): (19, 19, 36),            # the shipped eval batch
         (5, 23, 512): (10, 10, 113),           # 1265 rows
         (1, 2, 256): (1, 1, 1)}                # one pair


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan(shape):
    b, v, f = shape
    plan = pair_mlp.pair_mlp_plan(b, v, f)
    assert (plan["tiles"], plan["grid"], plan["last_tile_rows"]) == \
        PLANS[shape]
    assert plan["rows"] == b * v * (v - 1) // 2
    assert (plan["tiles"] - 1) * pair_mlp.BM + plan["last_tile_rows"] == \
        plan["rows"]
    assert plan["smem_bytes"] <= pair_mlp.SMEM_LIMIT
    assert plan["grid"] * plan["tiles_per_cta"] >= plan["tiles"]
    assert plan["chunks_per_tile"] == (f + f // 2) // pair_mlp.KC
    if b == 512:
        assert plan["tiles"] > pair_mlp.SMS


@pytest.mark.parametrize("shape", [(4, 40, 64), (4, 40, 384), (4, 1, 512),
                                   (0, 40, 512)])
def test_plan_refuses(shape):
    with pytest.raises(ValueError):
        pair_mlp.pair_mlp_plan(*shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pack_weights_layout(dtype):
    m, *_ = _head(dtype, 8)
    p = m.pair_params()
    w3, w4, vec = pair_mlp.pack_weights(p)
    f2, f4 = F // 2, F // 4
    assert w3.dtype == w4.dtype == torch.bfloat16
    assert w3.shape == (f2, F) and w4.shape == (f4, f2)
    assert vec.dtype == torch.float32
    assert vec.shape == (4 * F + 3 * f2 + 2 * f4 + 1,)

    def bf(t):
        return t.detach().reshape(-1).to(torch.bfloat16).float()

    parts = [bf(p.w_d), bf(p.b2), p.ln2_w.detach(), p.ln2_b.detach(),
             bf(p.b3), p.ln3_w.detach(), p.ln3_b.detach(), bf(p.b4),
             bf(p.w5), bf(p.b5)]
    assert torch.equal(vec, torch.cat(parts))
    assert torch.equal(p.w_d, m.Dense_2.kernel[2 * F + 6])


class _Reached(Exception):
    pass


def _stub(*args, **kwargs):
    raise _Reached


# (device, dtype, autograd on, train, F, V) -> the kernel?
RULE = [("cuda", torch.bfloat16, False, False, 512, 40, True),
        ("cuda", torch.bfloat16, False, False, 256, 2, True),
        ("cuda", torch.bfloat16, True, False, 512, 40, False),
        ("cuda", torch.float32, False, False, 512, 40, False),
        ("cuda", torch.bfloat16, False, True, 512, 40, False),
        ("cuda", torch.bfloat16, False, False, 1024, 40, False),
        ("cuda", torch.bfloat16, False, False, 128, 40, False),
        ("cuda", torch.bfloat16, False, False, 512, 1, False),
        ("cpu", torch.bfloat16, False, False, 512, 40, False),
        ("cpu", torch.float32, True, True, 512, 40, False)]


@pytest.mark.parametrize("case", RULE)
def test_dispatch_rule(case):
    device, dtype, grad, train, f, v, kernel = case
    with torch.set_grad_enabled(grad):
        assert pair_mlp.engages(torch.device(device), dtype, train, f,
                                v) is kernel


@pytest.mark.parametrize("mode", ["autograd on", "f32", "train", "cpu",
                                  "width", "kernel"])
def test_model_takes_eager_path(mode, monkeypatch):
    """With the op stubbed to raise, every path that must stay eager runs
    and matches the plain version; where the rule says kernel (forced for
    a CPU tensor here), the stub is reached.  "width": the rule itself,
    shown a CUDA device, at edge_hidden_dim 128, which the kernel is not
    built for."""
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    m, verts, feats, live = _head(dtype, 8, rate=0.0,
                                  f=128 if mode == "width" else F)
    monkeypatch.setattr(pair_mlp, "pair_mlp", _stub)
    if mode == "width":
        rule = pair_mlp.engages
        monkeypatch.setattr(pair_mlp, "engages", lambda d, *a: rule(
            torch.device("cuda"), *a))
    if mode == "kernel":
        monkeypatch.setattr(pair_mlp, "engages", lambda *a: True)
        with torch.no_grad(), pytest.raises(_Reached):
            m(verts, live, slot_features=feats)
        return
    with torch.set_grad_enabled(mode == "autograd on"):
        got = m(verts, live, slot_features=feats, train=mode == "train",
                generator=torch.Generator().manual_seed(1))
        x, u_i, u_j = m.slot_rows(verts, live, feats)
        want = pair_mlp.pair_mlp_plain(u_i, u_j, x, live, m.pair_params(),
                                       dtype=dtype)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_device_call_without_the_library_raises(monkeypatch, tmp_path):
    """The kernel route on a host with no built library and no compiler
    raises; it never falls back to the plain version.  On the CPU the op
    takes the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    m, verts, feats, live = _head(torch.bfloat16, 40)
    with torch.no_grad():
        x, u_i, u_j = m.slot_rows(verts, live, feats)
        p = m.pair_params()
        big = EdgePredictor(hidden_dim=256, num_heads=HEADS,
                            slot_feature_dim=SLOT, dtype=torch.bfloat16)
        ub = torch.zeros(u_i.shape[:2] + (256,), dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="nvcc"):
            pair_mlp._launch(ub, ub, x, live, big.pair_params(),
                             dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="bfloat16"):
            pair_mlp._launch(ub.float(), ub.float(), x.float(), live,
                             big.pair_params(), dtype=torch.float32)
        got = pair_mlp.pair_mlp(u_i, u_j, x, live, p, dtype=torch.bfloat16)
        want = pair_mlp.pair_mlp_plain(u_i, u_j, x, live, p,
                                       dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
