"""The port's PointCloudToWireframe against the flax model.

The recipe architecture (query head, existence slot masks, slot
features, kv_pool 4, the fused encoder) at small width, from the same
weights carried over by the bridge and the same numpy inputs.  In f32
the two agree to float noise (rtol 1e-5, atol 2e-5); in bf16 they round
at the same places but in different summation orders, so the outputs
agree to a few bf16 ulps (vertices atol 5e-2 in the unit-sphere frame,
probabilities atol 2e-2).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.models.wireframe import PointCloudToWireframe as JaxModel
from wireframe_tpu_torch.bridge import flatten_params, params_from_flax
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe

RECIPE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "recommended.yaml")
SMALL = ("model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=32")
F32 = dict(rtol=1e-5, atol=2e-5)
BF16 = {"vertices": 5e-2, "existence_probabilities": 2e-2,
        "edge_probs": 2e-2, "global_features": 5e-2}


@functools.lru_cache(maxsize=None)
def _params(overrides):
    """Flax init, then randomized biases and slot queries (flax's own init
    makes every slot nearly the same and zeroes the biases, which would
    hide slot-order and padding-row mistakes)."""
    cfg = jax_load_config(RECIPE, list(overrides))
    model = JaxModel(cfg.model)
    x = jnp.zeros((1, 64, cfg.model.input_dim), jnp.float32)
    params = jax.jit(lambda key: model.init({"params": key}, x, None,
                                            train=False)["params"])(
        jax.random.PRNGKey(0))
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    flat["vertex_decoder/slot_queries"] = rng.normal(
        size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)
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


def _cloud(seed, b=3, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 8)).astype(np.float32)
    x[0, 40:] = 0.0
    x[1, :6] = 0.0
    x[2, 50:] = 0.0
    return x


def _run(overrides, x):
    flat = _params(tuple(overrides))
    jcfg = jax_load_config(RECIPE, list(overrides))
    jm = JaxModel(jcfg.model)
    want = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, None,
                                          train=False))(_nested(flat),
                                                        jnp.asarray(x))
    tm = PointCloudToWireframe(load_config(RECIPE, list(overrides)).model)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("extra", [
    ("data.z_sort_points=true",),
    ("data.z_sort_points=false",),
    ("data.z_sort_points=false", "model.use_pallas_encoder=false"),
    ("model.slot_mask_mode=prefix", "model.edge_use_slot_features=false"),
])
def test_recipe_model_matches_flax_f32(extra):
    overrides = SMALL + ("model.compute_dtype=float32",) + extra
    got, want = _run(overrides, _cloud(0))
    assert set(got) == set(want)
    for key in ("vertices", "existence_logits", "existence_probabilities",
                "edge_probs", "edge_logits", "global_features"):
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   err_msg=key, **F32)
    for key in ("slot_mask", "pair_mask", "actual_vertex_counts",
                "used_vertex_counts"):
        np.testing.assert_array_equal(got[key].numpy(), want[key],
                                      err_msg=key)
    live = want["slot_mask"]
    assert live.any() and not live.all(), "weights must give mixed slots"


def test_recipe_model_matches_flax_bf16():
    overrides = SMALL + ("model.compute_dtype=bfloat16",)
    got, want = _run(overrides, _cloud(1))
    for key, atol in BF16.items():
        np.testing.assert_allclose(got[key].float().numpy(),
                                   want[key].astype(np.float32),
                                   rtol=0, atol=atol, err_msg=key)
    p = want["existence_probabilities"]
    clear = np.abs(p - 0.5) > BF16["existence_probabilities"]
    np.testing.assert_array_equal(got["slot_mask"].numpy()[clear],
                                  want["slot_mask"][clear])


def test_unsorted_cloud_is_sorted_in_graph():
    """points_z_sorted=false: the model z-sorts (invalid rows last), so a
    row permutation of the cloud changes nothing."""
    overrides = list(SMALL) + ["model.compute_dtype=float32",
                               "data.z_sort_points=false"]
    tm = PointCloudToWireframe(load_config(RECIPE, overrides).model)
    tm.load_state_dict(params_from_flax(_params(tuple(overrides))))
    x = _cloud(2)
    perm = np.random.default_rng(3).permutation(x.shape[1])
    with torch.no_grad():
        a = tm.eval()(torch.from_numpy(x))
        b = tm(torch.from_numpy(x[:, perm]))
    np.testing.assert_allclose(a["vertices"].numpy(), b["vertices"].numpy(),
                               **F32)


@pytest.mark.parametrize("bad", ["model.decoder_scan=true",
                                 "model.decoder_fused_cross_kv=true"])
def test_unported_layouts_raise(bad):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PointCloudToWireframe(load_config(RECIPE, list(SMALL) + [bad]).model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_flax_mha(dtype):
    """flax MultiHeadDotProductAttention semantics: DenseGeneral layouts,
    query scaled by sqrt(hd) in the dtype, finfo.min mask fill, softmax
    in the module dtype."""
    import flax.linen as fnn

    from wireframe_tpu_torch.models.attention import (
        MultiHeadDotProductAttention,
    )

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 6, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 9, 16)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, 6, 9)) > 0.3
    mask[1, 0, 2] = False                         # a fully masked query row
    jm = fnn.MultiHeadDotProductAttention(num_heads=4, dtype=jdt)
    params = jm.init(jax.random.PRNGKey(0), q, kv, kv)["params"]
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(size=v.shape).astype(
            np.float32) * 0.1, params)
    want = np.asarray(jm.apply({"params": params}, q, kv, kv,
                               mask=jnp.asarray(mask)), np.float32)
    tm = MultiHeadDotProductAttention(16, 4, tdt)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(kv),
                 torch.from_numpy(mask)).float().numpy()
    tol = F32 if dtype == "float32" else dict(rtol=0, atol=3e-2)
    np.testing.assert_allclose(got, want, **tol)


def test_kv_pool_that_cannot_fuse_warns_and_matches_flax(caplog):
    """decoder_kv_pool=8 at tile 32 leaves a pooled tile of 4 rows: the
    encoder warns and the decoder window-pools the point features itself,
    as in the JAX package."""
    overrides = SMALL + ("model.compute_dtype=float32",
                         "model.decoder_kv_pool=8")
    with caplog.at_level("WARNING"):
        got, want = _run(overrides, _cloud(4))
    assert "cannot be fused" in caplog.text
    for key in ("vertices", "existence_probabilities", "edge_probs"):
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   err_msg=key, **F32)


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_layer_norm_and_gelu_match_flax(scale):
    """flax LayerNorm: eps 1e-6 (torch's default is 1e-5) and the fast
    variance; at scale 1e-3 the variance is ~eps, so the eps matters.
    flax gelu is the tanh approximation."""
    import flax.linen as fnn

    from wireframe_tpu_torch.models.layers import LayerNorm, gelu

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 24)) * scale + 0.5 * scale).astype(np.float32)
    jm = fnn.LayerNorm(dtype=jnp.float32)
    params = {"scale": rng.normal(size=24).astype(np.float32),
              "bias": rng.normal(size=24).astype(np.float32)}
    want = np.asarray(jm.apply({"params": params}, x))
    ln = LayerNorm(24)
    ln.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"])})
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(
        gelu(torch.from_numpy(x / scale)).numpy(),
        np.asarray(fnn.gelu(jnp.asarray(x / scale))), **F32)
