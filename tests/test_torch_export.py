"""`export_port_checkpoint.py`: a JAX package checkpoint into the port.

A JAX recipe run at small width (bridged weights with randomized biases
and slot queries, 2 steps of the JAX `make_train_step` at constant LR,
Pallas matcher in interpret mode; the plain encoder chain, whose
parameter tree is the kernel's) is saved through orbax with its Adam
state and an `ema/` checkpoint, as the JAX `main.py` saves them, then
exported:
- the params, the EMA and Adam's mu / nu / count are the JAX arrays
  exactly, and the metadata keeps step, epoch and config;
- the port's forward from the exported checkpoint matches the flax
  model's within F32 (rtol 1e-5, atol 2e-5);
- restored into a port train state (what `main --resume` does), one more
  step on the same batch as one more JAX step gives the loss within rtol
  1e-4 and every parameter within 2 lr (Adam normalizes each update to
  about lr, so where a gradient is near 0 its sign can flip between the
  two float orders; tests/test_torch_train.py);
- the same with `train.flatten_optimizer=true` (optax.flatten: the
  moments are one vector each) and in the scanned, fused layout;
- a params-only checkpoint exports without opt_state.npz.
Dropout and the device augmentation are off: the packages draw from
different random streams.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.models.wireframe import PointCloudToWireframe as JaxModel
from wireframe_tpu.train import checkpoint as jax_checkpoint
from wireframe_tpu.train.state import create_train_state as jax_create_state
from wireframe_tpu.train.step import make_train_step as jax_make_train_step
from wireframe_tpu_torch.bridge import (
    flatten_params,
    params_from_flax,
    state_dict_to_flax,
)
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.serve import WireframePredictor
from wireframe_tpu_torch.train.checkpoint import (
    load_checkpoint,
    restore_train_state,
)
from wireframe_tpu_torch.train.loop import init_model
from wireframe_tpu_torch.train.state import create_train_state
from wireframe_tpu_torch.train.step import make_train_step
from wireframe_tpu_torch.utils.synth import make_random_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import export_port_checkpoint  # noqa: E402

RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "data.num_points=64",
         "train.batch_size=2", "model.compute_dtype=float32",
         "model.use_pallas_encoder=false", "train.matcher=pallas",
         "model.attn_dropout=0", "model.edge_dropout=0",
         "train.device_augment=false", "train.lr_schedule=constant",
         "train.num_epochs=2"]
CASES = {"unrolled": [],
         "flatten_optimizer": ["train.flatten_optimizer=true"],
         "scan_fused": ["model.decoder_scan=true",
                        "model.decoder_fused_cross_kv=true"]}
F32 = dict(rtol=1e-5, atol=2e-5)
STEPS = 2


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _np(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module", params=list(CASES))
def run(request, tmp_path_factory):
    """The JAX run, its orbax checkpoint, and the export."""
    overrides = SMALL + CASES[request.param]
    jcfg = jax_load_config(RECIPE, overrides)
    cfg = load_config(RECIPE, overrides)
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0), (2, 64, 8))
    flat = _np(jstate.params)
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    flat["vertex_decoder/slot_queries"] = rng.normal(
        size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)
    jstate = jstate.replace(params=_nested(flat), ema_params=_nested(flat))
    # Targets near distinct predicted slots: a clear matching margin.
    batch = make_random_batch(cfg, 2, seed=3)
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["point_clouds"]),
                     torch.from_numpy(batch["vertex_counts"]),
                     train=True)["vertices"].numpy()
    for i, c in enumerate(batch["vertex_counts"]):
        slots = rng.permutation(pred.shape[1])[:c]
        batch["target_vertices"][i, :c] = (
            pred[i, slots] + rng.normal(size=(c, 3)) * 0.05)

    jstep = jax.jit(jax_make_train_step(jcfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(STEPS):
        jstate, _ = jstep(jstate, jb, jax.random.PRNGKey(i))
    tmp = tmp_path_factory.mktemp(request.param)
    ck, out = str(tmp / "jax"), str(tmp / "port")
    jax_checkpoint.save_checkpoint(ck, STEPS, jstate.params,
                                   jstate.opt_state, jcfg, epoch=STEPS)
    jax_checkpoint.save_checkpoint(os.path.join(ck, "ema"), STEPS,
                                   jstate.ema_params, None, jcfg,
                                   epoch=STEPS)
    assert export_port_checkpoint.main(["--checkpoint-dir", ck,
                                        "--out-dir", out]) == 0
    return dict(case=request.param, jcfg=jcfg, cfg=cfg, jstate=jstate,
                jstep=jstep, batch=batch, ck=ck, out=out)


def test_exported_arrays_are_the_jax_arrays(run):
    jstate, cfg = run["jstate"], run["cfg"]
    payload, meta = load_checkpoint(run["out"])
    assert (meta["step"], meta["epoch"]) == (STEPS, STEPS)
    with open(os.path.join(run["ck"], f"step_{STEPS}.meta.json")) as f:
        want_meta = json.load(f)
    for key in ("config", "max_vertices", "input_dim"):
        assert meta[key] == want_meta[key], key
    for got, want in ((payload["params"], _np(jstate.params)),
                      (load_checkpoint(os.path.join(run["out"], "ema"))[0][
                          "params"], _np(jstate.ema_params))):
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert payload["count"] == int(adam.count) == STEPS
    for name in ("mu", "nu"):
        want = getattr(adam, name)
        if cfg.train.flatten_optimizer:
            assert np.ndim(want) == 1
            want = ravel_pytree(jstate.params)[1](want)
        want = _np(want)
        assert set(payload[name]) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(payload[name][k], w,
                                          err_msg=f"{name} {k}")
    assert not os.path.exists(os.path.join(run["out"], "ema",
                                           f"step_{STEPS}", "opt_state.npz"))


def test_exported_checkpoint_serves_the_jax_forward(run):
    jstate = run["jstate"]
    x = run["batch"]["point_clouds"]
    jm = JaxModel(run["jcfg"].model)
    want = jm.apply({"params": jstate.params}, jnp.asarray(x), None,
                    train=False)
    # The architecture comes from the exported config.json alone.
    predictor = WireframePredictor(
        os.path.join(run["out"], f"step_{STEPS}"), config=RECIPE,
        device="cpu")
    with torch.no_grad():
        got = predictor.model(torch.from_numpy(x))
    for key in ("vertices", "existence_probabilities", "edge_probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **F32)


def test_resume_takes_the_jax_next_step(run):
    cfg, batch = run["cfg"], run["batch"]
    state = create_train_state(cfg, init_model(cfg, "cpu"))
    state, start = restore_train_state(state, run["out"])
    assert (state.step, start) == (STEPS, STEPS)
    step = make_train_step(cfg)
    lr = step.optimizer.lr(state.step)
    state, got = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()},
                      torch.Generator().manual_seed(0))
    jstate, want = run["jstep"](run["jstate"],
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(STEPS))
    np.testing.assert_allclose(float(got["total_loss"]),
                               float(want["total_loss"]), rtol=1e-4)
    got_p = state_dict_to_flax(state.params, cfg.model)
    for k, w in _np(jstate.params).items():
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=2 * lr + 1e-6,
                                   err_msg=k)


def test_params_only_checkpoint_exports_without_opt_state(tmp_path):
    jcfg = jax_load_config(RECIPE, SMALL)
    params = jax_create_state(jcfg, jax.random.PRNGKey(1),
                              (1, 64, 8)).params
    ck, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_checkpoint.save_checkpoint(ck, 5, params, None, jcfg, epoch=1)
    assert export_port_checkpoint.main(["--checkpoint-dir", ck, "--step",
                                        "5", "--out-dir", out]) == 0
    assert sorted(os.listdir(out)) == ["step_5", "step_5.meta.json"]
    assert sorted(os.listdir(os.path.join(out, "step_5"))) == [
        "config.json", "params.npz"]
    payload, meta = load_checkpoint(out)
    assert payload["mu"] is None and meta["epoch"] == 1
    want = _np(params)
    for k, w in want.items():
        np.testing.assert_array_equal(payload["params"][k], w, err_msg=k)
