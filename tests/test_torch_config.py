"""The port's config tree against the JAX package's (wireframe_tpu_torch.config).

Same yaml + `--set` overrides must give the same `config_to_dict` in
both packages, the same derived fields, and the same override errors.
"""

import os

import pytest

from wireframe_tpu import config as jax_config
from wireframe_tpu.train.checkpoint import apply_checkpoint_model_config
from wireframe_tpu_torch import config as port_config

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")

OVERRIDES = ["model.decoder_layers=2", "data.point_buckets=64,128",
             "data.z_sort_points=false", "model.max_vertices=12",
             "train.learning_rate=1e-3", "eval.edge_confidence_thresh=0.3",
             "model.encoder_hidden_dims=32,64", "data.use_intensity=false",
             "model.use_pallas_encoder=true"]


@pytest.mark.parametrize("yaml_name,overrides", [
    (None, []),
    ("recommended.yaml", []),
    ("recommended.yaml", OVERRIDES),
    ("default.yaml", []),
    (None, OVERRIDES),
])
def test_same_config_dict(yaml_name, overrides):
    path = os.path.join(CONFIGS, yaml_name) if yaml_name else None
    want = jax_config.config_to_dict(jax_config.load_config(path, overrides))
    got = port_config.config_to_dict(port_config.load_config(path, overrides))
    assert got == want


def test_recipe_derived_fields():
    cfg = port_config.load_config(os.path.join(CONFIGS, "recommended.yaml"))
    assert cfg.model.max_vertices == cfg.data.max_vertices == 40
    assert cfg.model.input_dim == 8
    assert cfg.model.points_z_sorted is True
    assert cfg.model.vertex_head == "query"
    assert cfg.model.decoder_kv_pool == 4


@pytest.mark.parametrize("bad", ["model.nope=1", "model.input_dim=4",
                                 "model.points_z_sorted=true"])
def test_same_override_errors(bad):
    with pytest.raises(KeyError):
        jax_config.load_config(None, [bad])
    with pytest.raises(KeyError):
        port_config.load_config(None, [bad])


def test_saved_model_config_matches_jax_checkpoint_rule():
    """A checkpoint's model section overrides the architecture and its
    input-feature flags, exactly as the JAX checkpoint loader does."""
    saved = jax_config.config_to_dict(jax_config.load_config(
        os.path.join(CONFIGS, "recommended.yaml"),
        ["model.decoder_dim=64", "data.scale_intensity=false",
         "data.max_vertices=24"]))
    jcfg = apply_checkpoint_model_config(
        jax_config.load_config(None, ["data.z_sort_points=true"]),
        {"config": saved})
    pcfg = port_config.apply_saved_model_config(
        port_config.load_config(None, ["data.z_sort_points=true"]), saved)
    assert port_config.config_to_dict(pcfg) == jax_config.config_to_dict(jcfg)
