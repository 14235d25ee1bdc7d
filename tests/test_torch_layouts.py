"""Every model shape the JAX package builds, in the port.

The five shapes: the recipe's query decoder unrolled (`block{i}`), with
fused cross-attention K/V (`decoder_fused_cross_kv`), scanned
(`decoder_scan`, stacked `blocks/block` leaves), scanned and fused, and
the parity model's MLP head.  At small width (the `SMALL` overrides of
tests/test_torch_model.py), for each:
- `bridge.flax_param_shapes` is the JAX `model.init` tree, path for path
  and shape for shape, and flax -> state_dict -> flax is exact;
- `bridge.init_flax_params` draws every kernel at flax's scale: the std
  of each kernel leaf of 1,024 or more elements within 10% of the JAX
  init's (the estimate's own noise is ~2% at 1,024 elements);
- the forward from bridged JAX weights (randomized biases and slot
  queries) matches the flax model's within F32 (rtol 1e-5, atol 2e-5)
  and, in bf16, within the BF16 atols of tests/test_torch_model.py; the
  JAX side runs its Pallas encoder in interpret mode, as its own tests do;
- one train-mode loss and its gradients match `jax.value_and_grad` of
  the JAX step's loss (dropout and augmentation off: the two draw from
  different random streams): the loss rtol 1e-5, each gradient within
  rtol 1e-4 plus 1e-4 of its leaf's largest entry (the same f32
  arithmetic in other summation orders) plus 1e-7 (the attention key
  biases have an analytic gradient of 0, a softmax does not see a
  shift, so both sides hold float noise of ~1e-9 there);
- in the port, scan equals unrolled and remat equals no remat bit for
  bit, dropout on, and remat makes autograd save fewer bytes.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.losses.wireframe_loss import WireframeLossConfig
from wireframe_tpu.losses.wireframe_loss import wireframe_loss as jax_loss
from wireframe_tpu.models.wireframe import PointCloudToWireframe as JaxModel
from wireframe_tpu_torch import bridge
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.losses.wireframe_loss import wireframe_loss
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.train.step import loss_config
from wireframe_tpu_torch.utils.synth import make_random_batch

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
RECIPE = os.path.join(CONFIGS, "recommended.yaml")
PARITY = os.path.join(CONFIGS, "default.yaml")
SMALL = ("model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=32",
         "model.pallas_chain_tile=32")
FUSED = ("model.decoder_fused_cross_kv=true",)
SCAN = ("model.decoder_scan=true",)
LAYOUTS = {
    "unrolled": (RECIPE, SMALL),
    "fused": (RECIPE, SMALL + FUSED),
    "scan": (RECIPE, SMALL + SCAN),
    "scan_fused": (RECIPE, SMALL + SCAN + FUSED),
    "mlp": (PARITY, SMALL + ("model.use_pallas_encoder=true",)),
}
QUERY = ("unrolled", "fused", "scan", "scan_fused")
F32 = dict(rtol=1e-5, atol=2e-5)
BF16 = {"vertices": 5e-2, "existence_probabilities": 2e-2,
        "edge_probs": 2e-2, "global_features": 5e-2, "slot_features": 5e-2}
# One train-mode step: the plain encoder chain (the kernels' own steps
# are held in tests/test_torch_train.py), device matcher, no dropout.
STEP = ("model.use_pallas_encoder=false", "model.compute_dtype=float32",
        "train.matcher=pallas", "model.attn_dropout=0",
        "model.edge_dropout=0", "train.device_augment=false",
        "data.num_points=64")


def _cfgs(layout, extra=()):
    path, overrides = LAYOUTS[layout]
    overrides = list(overrides) + list(extra)
    return (jax_load_config(path, overrides).model,
            load_config(path, overrides).model)


@functools.lru_cache(maxsize=None)
def _jax_init(layout):
    """The JAX model's own init tree (flat), through the plain chain: the
    kernel flag does not change the tree."""
    jcfg, _ = _cfgs(layout, ("model.use_pallas_encoder=false",))
    model = JaxModel(jcfg)
    x = jnp.zeros((1, 64, jcfg.input_dim), jnp.float32)
    params = jax.jit(lambda key: model.init({"params": key}, x, None,
                                            train=False)["params"])(
        jax.random.PRNGKey(0))
    return bridge.flatten_params(jax.tree_util.tree_map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def _weights(layout):
    """The JAX init with randomized biases and slot queries (flax zeroes
    the biases and makes every slot nearly alike, which would hide
    slot-order and padding mistakes)."""
    rng = np.random.default_rng(7)
    flat = dict(_jax_init(layout))
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    if "vertex_decoder/slot_queries" in flat:
        flat["vertex_decoder/slot_queries"] = rng.normal(
            size=flat["vertex_decoder/slot_queries"].shape).astype(
                np.float32)
    return flat


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _port(cfg, flat):
    model = PointCloudToWireframe(cfg)
    model.load_state_dict(bridge.params_from_flax(flat), strict=True)
    return model


def _cloud(seed, b=3, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 8)).astype(np.float32)
    x[0, 40:] = 0.0
    x[1, :6] = 0.0
    x[2, 50:] = 0.0
    return x


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_param_tree_is_the_jax_tree_and_round_trips(layout):
    _, cfg = _cfgs(layout)
    want = _jax_init(layout)
    assert bridge.flax_param_shapes(cfg) == {k: v.shape
                                             for k, v in want.items()}
    flat = _weights(layout)
    model = _port(cfg, flat)
    assert len(model.state_dict()) == len(flat)
    back = bridge.state_dict_to_flax(model.state_dict(), cfg)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_init_scales_are_flax_scales(layout):
    """ROADMAP C4: every kernel at the JAX init's scale.  The FFN output
    kernel (F, D), whose path ends in `out/kernel`, once took the
    attention output's fan-in F*D: 16x too small at the recipe's widths."""
    _, cfg = _cfgs(layout)
    ours = bridge.init_flax_params(cfg, seed=0)
    theirs = _jax_init(layout)
    checked = []
    for k, v in theirs.items():
        if v.size >= 1024 and (k.endswith("kernel") or k.endswith("_w")):
            ratio = ours[k].std() / v.std()
            assert abs(ratio - 1.0) < 0.1, f"{k}: std ratio {ratio:.3f}"
            checked.append(k)
    ffn_out = [k for k in checked if "ffn_out" in k]
    if layout in QUERY:
        assert ffn_out, "no ffn_out kernel checked"
        for k in ffn_out:
            fan_in = cfg.decoder_ffn_dim
            assert abs(ours[k].std() * fan_in ** 0.5 - 1.0) < 0.1, (
                f"ffn_out kernel {k} std {ours[k].std():.4f}, flax's "
                f"{fan_in ** -0.5:.4f}")


def _forwards(layout, dtype, x):
    """(port, flax) outputs from the same weights, each with the vertex
    decoder's slot features beside the model's outputs."""
    jcfg, cfg = _cfgs(layout, (f"model.compute_dtype={dtype}",))
    flat = _weights(layout)
    jm = JaxModel(jcfg)
    want, inter = jax.jit(lambda p, xx: jm.apply(
        {"params": p}, xx, None, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(_nested(flat), jnp.asarray(x))
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    model = _port(cfg, flat).eval()
    got = {}
    if layout in QUERY:
        want["slot_features"] = np.asarray(
            inter["intermediates"]["vertex_decoder"]["__call__"][0][
                "slot_features"], np.float32)
        model.vertex_decoder.register_forward_hook(
            lambda m, i, out: got.update(slot_features=out["slot_features"]))
    with torch.no_grad():
        got.update(model(torch.from_numpy(x)))
    return {k: v.float().numpy() for k, v in got.items()}, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forward_matches_flax(layout, dtype):
    got, want = _forwards(layout, dtype, _cloud(1))
    keys = ["vertices", "existence_logits", "existence_probabilities",
            "edge_probs", "global_features"]
    if layout in QUERY:
        keys.append("slot_features")
    for key in keys:
        if dtype == "float32":
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **F32)
        elif key in BF16:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=BF16[key], err_msg=key)
    live = want["existence_probabilities"] > 0.5
    assert live.any() and not live.all(), "weights must give mixed slots"


def _batch(cfg_path, overrides, b=2):
    """A `make_random_batch` batch whose targets sit near distinct slots
    of the model's first prediction (a clear matching margin: a near-tie
    would let float noise pick another assignment)."""
    cfg = load_config(cfg_path, overrides)
    return cfg, make_random_batch(cfg, b, seed=3)


def _near_slots(batch, pred, seed=5):
    rng = np.random.default_rng(seed)
    for i, c in enumerate(batch["vertex_counts"]):
        slots = rng.permutation(pred.shape[1])[:c]
        batch["target_vertices"][i, :c] = (
            pred[i, slots] + rng.normal(size=(c, 3)) * 0.05)
    return batch


def _targets(batch, lib):
    return {"vertices": lib(batch["target_vertices"]),
            "vertex_existence": lib(batch["vertex_existence"]),
            "edge_labels": lib(batch["edge_labels"]),
            "vertex_counts": lib(batch["vertex_counts"])}


def _port_loss_and_grads(model, cfg, batch, generator=None):
    preds = model(torch.from_numpy(batch["point_clouds"]),
                  torch.from_numpy(batch["vertex_counts"]), train=True,
                  generator=generator)
    loss = wireframe_loss(preds, _targets(batch, torch.from_numpy),
                          loss_config(cfg))["total_loss"]
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, {k: (torch.zeros_like(p) if g is None else g)
                  for k, p, g in zip(names, params, grads)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_loss_and_gradients_match_jax(layout):
    path, overrides = LAYOUTS[layout]
    overrides = list(overrides) + list(STEP)
    jcfg = jax_load_config(path, overrides)
    cfg, batch = _batch(path, overrides)
    flat = _weights(layout)
    model = _port(cfg.model, flat)
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["point_clouds"]),
                     torch.from_numpy(batch["vertex_counts"]),
                     train=True)["vertices"].numpy()
    batch = _near_slots(batch, pred)
    loss, grads = _port_loss_and_grads(model, cfg, batch)
    got = bridge.state_dict_to_flax(grads, cfg.model)

    jm = JaxModel(jcfg.model)
    lcfg = WireframeLossConfig(**vars(loss_config(cfg)))

    def loss_fn(p):
        preds = jm.apply({"params": p}, jnp.asarray(batch["point_clouds"]),
                         jnp.asarray(batch["vertex_counts"]), train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss(preds, _targets(batch, jnp.asarray),
                        lcfg)["total_loss"]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(_nested(flat))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = bridge.flatten_params(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=k)


DROPOUT = ("model.decoder_dropout=0.2", "model.attn_dropout=0.1",
           "model.edge_dropout=0.1", "model.use_pallas_encoder=false",
           "data.num_points=64")


def _seeded():
    return torch.Generator().manual_seed(11)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_scan_equals_unrolled(fused, dtype):
    """The same weights restacked: the scanned decoder computes the
    unrolled one's outputs, loss and gradients bit for bit, in eval mode
    and in train mode with dropout on (the same draws, in the same
    order)."""
    extra = (FUSED if fused else ()) + DROPOUT + (
        f"model.compute_dtype={dtype}",)
    unrolled = "fused" if fused else "unrolled"
    _, cfg_u = _cfgs(unrolled, extra)
    _, cfg_s = _cfgs("scan_fused" if fused else "scan", extra)
    flat = _weights(unrolled)
    stacked = bridge.stack_layers(flat, cfg_u.decoder_layers)
    mu, ms = _port(cfg_u, flat), _port(cfg_s, stacked)
    x = torch.from_numpy(_cloud(2))
    with torch.no_grad():
        a, b = mu.eval()(x), ms.eval()(x)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    cfg, batch = _batch(RECIPE, list(SMALL) + list(extra))
    gu, gs = _seeded(), _seeded()
    lu, grads_u = _port_loss_and_grads(mu.train(), cfg, batch, gu)
    ls, grads_s = _port_loss_and_grads(ms.train(), cfg, batch, gs)
    assert torch.equal(lu, ls)
    assert torch.equal(gu.get_state(), gs.get_state())
    fu = bridge.state_dict_to_flax(grads_u, cfg_u)
    fs = bridge.state_dict_to_flax(grads_s, cfg_s)
    for k, v in bridge.stack_layers(fu, cfg_u.decoder_layers).items():
        np.testing.assert_array_equal(fs[k], v, err_msg=k)


def _saved_bytes(model, cfg, batch, generator):
    """Loss, gradients and the bytes of the tensors autograd saved in the
    forward and loss (each storage once, weights and inputs excluded)."""
    kept = {p.untyped_storage().data_ptr() for p in model.parameters()}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in kept:
            saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, grads = _port_loss_and_grads(model, cfg, batch, generator)
    return loss, grads, sum(saved.values())


@pytest.mark.parametrize("layout", ["unrolled", "fused", "scan_fused"])
def test_remat_gradients_equal_with_dropout_on(layout):
    """decoder_remat recomputes each block in the backward.  Dropout
    draws from the caller's generator, which torch.utils.checkpoint does
    not save: the block replays the forward's masks, so loss, gradients
    and the generator's final state equal the run without remat, and
    autograd keeps fewer bytes."""
    path, overrides = LAYOUTS[layout]
    cfg, batch = _batch(path, list(overrides) + list(DROPOUT))
    remat_cfg, _ = _batch(path, list(overrides) + list(DROPOUT)
                          + ["model.decoder_remat=true"])
    flat = _weights(layout)
    g0, g1 = _seeded(), _seeded()
    l0, grads0, bytes0 = _saved_bytes(_port(cfg.model, flat).train(), cfg,
                                      batch, g0)
    l1, grads1, bytes1 = _saved_bytes(_port(remat_cfg.model, flat).train(),
                                      remat_cfg, batch, g1)
    assert torch.equal(l0, l1)
    assert torch.equal(g0.get_state(), g1.get_state())
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    assert bytes1 < bytes0, (bytes1, bytes0)
