"""Flax -> port weight bridge (wireframe_tpu_torch.bridge).

Every leaf of a real JAX `PointCloudToWireframe.init` tree must be
consumed exactly once into the port model's state_dict with matching
shapes, the port's own description of the flax tree must equal the real
one, and the npz checkpoint must round-trip exactly.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.models.wireframe import PointCloudToWireframe as JaxModel
from wireframe_tpu_torch import bridge
from wireframe_tpu_torch.config import config_to_dict, load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe

RECIPE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "recommended.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=32"]


@functools.lru_cache(maxsize=None)
def _flax_tree_cached(overrides):
    # The kernel flag does not change the parameter layout; init through
    # the plain chain (one jitted program) to skip the Pallas interpreter.
    cfg = jax_load_config(RECIPE, [*overrides,
                                   "model.use_pallas_encoder=false"])
    model = JaxModel(cfg.model)
    x = jnp.zeros((1, 64, cfg.model.input_dim), jnp.float32)
    params = jax.jit(lambda key: model.init({"params": key}, x, None,
                                            train=False)["params"])(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _flax_tree(overrides):
    return _flax_tree_cached(tuple(overrides))


@pytest.mark.parametrize("extra", [[], ["model.edge_use_slot_features=false"]])
def test_every_flax_leaf_consumed_once(extra):
    overrides = SMALL + extra
    flat = bridge.flatten_params(_flax_tree(overrides))
    state = bridge.params_from_flax(flat)
    model = PointCloudToWireframe(load_config(RECIPE, overrides).model)
    expected = model.state_dict()
    assert len(state) == len(flat)
    assert set(state) == set(expected)
    for key, value in expected.items():
        assert tuple(state[key].shape) == tuple(value.shape), key
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("extra", [[], ["model.edge_use_slot_features=false"]])
def test_flax_param_shapes_match_init_tree(extra):
    overrides = SMALL + extra
    flat = bridge.flatten_params(_flax_tree(overrides))
    shapes = bridge.flax_param_shapes(load_config(RECIPE, overrides).model)
    assert shapes == {k: v.shape for k, v in flat.items()}


def test_recipe_shapes_full_width():
    """Full-width recipe: the encoder chain is 5.25 M parameters."""
    shapes = bridge.flax_param_shapes(load_config(RECIPE).model)
    chain = sum(int(np.prod(s)) for k, s in shapes.items()
                if k.endswith("_w"))
    assert chain == 8 * 512 + 512 * 1024 + 1024 * 2048 + 2048 * 1024 \
        + 1024 * 512
    assert shapes["edge_predictor/Dense_2/kernel"] == (1031, 512)
    assert shapes["vertex_decoder/slot_queries"] == (40, 256)


def test_layout_transforms():
    rng = np.random.default_rng(0)
    k2 = rng.normal(size=(5, 7)).astype(np.float32)
    qkv = rng.normal(size=(8, 2, 4)).astype(np.float32)
    out = rng.normal(size=(2, 4, 8)).astype(np.float32)
    pair = rng.normal(size=(11, 3)).astype(np.float32)
    state = bridge.params_from_flax({
        "a/Dense_0/kernel": k2, "a/attn/query/kernel": qkv,
        "a/attn/query/bias": qkv[0], "a/attn/out/kernel": out,
        "a/LayerNorm_0/scale": k2[0], "edge_predictor/Dense_2/kernel": pair,
        "encoder/stage0_w": k2})
    np.testing.assert_array_equal(state["a.Dense_0.weight"].numpy(), k2.T)
    np.testing.assert_array_equal(state["a.attn.query.weight"].numpy(),
                                  qkv.reshape(8, 8).T)
    np.testing.assert_array_equal(state["a.attn.query.bias"].numpy(),
                                  qkv[0].reshape(-1))
    np.testing.assert_array_equal(state["a.attn.out.weight"].numpy(),
                                  out.reshape(8, 8).T)
    np.testing.assert_array_equal(state["a.LayerNorm_0.weight"].numpy(),
                                  k2[0])
    np.testing.assert_array_equal(
        state["edge_predictor.Dense_2.kernel"].numpy(), pair)
    np.testing.assert_array_equal(state["encoder.stage0_w"].numpy(), k2)


def test_nested_dict_accepted():
    tree = _flax_tree(SMALL)
    a = bridge.params_from_flax(tree)
    b = bridge.params_from_flax(bridge.flatten_params(tree))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_npz_round_trip_exact(tmp_path):
    cfg = load_config(RECIPE, SMALL)
    flat = bridge.flatten_params(_flax_tree(SMALL))
    bridge.save_port_checkpoint(str(tmp_path), flat, cfg)
    params, config = bridge.load_port_checkpoint(str(tmp_path))
    assert set(params) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(params[k], v)
    assert config == json.loads(json.dumps(config_to_dict(cfg)))


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        bridge.load_port_checkpoint(str(tmp_path))


def test_init_flax_params_scales():
    cfg = load_config(RECIPE).model
    params = bridge.init_flax_params(cfg, seed=0)
    assert {k: v.shape for k, v in params.items()} == \
        bridge.flax_param_shapes(cfg)
    w = params["encoder/stage2_w"]                     # (1024, 2048)
    assert abs(w.std() - 1024 ** -0.5) < 0.05 * 1024 ** -0.5
    assert np.abs(w).max() <= 2.0 / 0.87962566103423978 * 1024 ** -0.5
    out = params["vertex_decoder/block0/self_attn/out/kernel"]  # (8, 32, 256)
    assert abs(out.std() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(params["vertex_decoder/slot_queries"].std() - 0.02) < 0.002
    assert not params["encoder/stage0_b"].any()
    assert (params["encoder/stage0_ln_scale"] == 1).all()
    assert (params["edge_predictor/LayerNorm_0/scale"] == 1).all()
    again = bridge.init_flax_params(cfg, seed=0)
    assert all(np.array_equal(again[k], v) for k, v in params.items())
