"""The reference-parity model in the port: the MLP vertex head against
flax, its checkpoints, resume and serving.

`configs/default.yaml` at small width (encoder 32/64 -> 32, edge head
32/4 heads, max_vertices 8; the MLP head keeps its fixed 4096/2048/2048/
1024 widths).  Against the flax model, from the same weights carried over
by the bridge (randomized biases), on the same numpy clouds: in f32 the
two agree to float noise (rtol 1e-5, atol 2e-5); in bf16 they round at
the same places in other summation orders, so vertices agree to 5e-2 in
the unit-sphere frame and probabilities to 2e-2 (a few bf16 ulps).

Training runs on the CPU through `train_model` with the plain versions
of K5 and K4: a checkpoint holds params, Adam state, step and epoch;
resuming it twice gives the same losses and the same state, bit for bit.
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
from wireframe_tpu_torch.bridge import (
    flatten_params,
    flax_param_shapes,
    params_from_flax,
    state_dict_to_flax,
)
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.train.checkpoint import (
    apply_checkpoint_model_config,
    latest_step,
    load_checkpoint,
    restore_train_state,
)
from wireframe_tpu_torch.train.loop import init_model, train_model
from wireframe_tpu_torch.train.metrics_logging import MetricWriter
from wireframe_tpu_torch.train.state import create_train_state
from wireframe_tpu_torch.utils.synth import (
    box_building_cloud,
    make_box_building_batch,
)

PARITY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "default.yaml")
SMALL = ("model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=32",
         "model.pallas_chain_tile=32", "data.num_points=64",
         "model.use_pallas_encoder=true")
F32 = dict(rtol=1e-5, atol=2e-5)
BF16 = {"vertices": 5e-2, "existence_probabilities": 2e-2,
        "edge_probs": 2e-2, "global_features": 5e-2}


@functools.lru_cache(maxsize=None)
def _params(overrides):
    """Flax init (plain chain: the layout is the same), then randomized
    biases, so that padding and slot-order mistakes show."""
    cfg = jax_load_config(PARITY, list(overrides)
                          + ["model.use_pallas_encoder=false"])
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
    flat = _params(tuple(o for o in overrides
                         if not o.startswith("model.compute_dtype")
                         and not o.startswith("model.use_pallas")))
    jm = JaxModel(jax_load_config(PARITY, list(overrides)).model)
    want = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, None,
                                          train=False))(_nested(flat),
                                                        jnp.asarray(x))
    tm = PointCloudToWireframe(load_config(PARITY, list(overrides)).model)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("use_pallas", ["true", "false"])
def test_mlp_model_matches_flax_f32(use_pallas):
    overrides = SMALL + ("model.compute_dtype=float32",
                         f"model.use_pallas_encoder={use_pallas}")
    got, want = _run(overrides, _cloud(0))
    # The MLP head returns no point features and no slot features.
    assert set(got) == set(want) and "point_features" not in got
    for key in ("vertices", "existence_logits", "existence_probabilities",
                "edge_probs", "edge_logits", "global_features"):
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   err_msg=key, **F32)
    for key in ("slot_mask", "pair_mask", "actual_vertex_counts",
                "used_vertex_counts"):
        np.testing.assert_array_equal(got[key].numpy(), want[key],
                                      err_msg=key)


def test_mlp_model_matches_flax_bf16():
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


def test_mlp_head_takes_no_kv_pool_and_no_sort():
    """The head decides, as in the JAX module: with the MLP head a
    configured decoder_kv_pool is ignored (no window pooling, no z-sort,
    no slot features), so a row permutation of the cloud changes
    nothing and the slot-feature flag does not change the layout."""
    base = SMALL + ("model.compute_dtype=float32",)
    cfg = load_config(PARITY, list(base) + ["model.decoder_kv_pool=4",
                                            "model.edge_use_slot_features"
                                            "=true"])
    model = PointCloudToWireframe(cfg.model)
    assert model.encoder.kv_pool == 0
    assert not model.encoder.point_features_for_kv
    shapes = flax_param_shapes(cfg.model)
    assert shapes == flax_param_shapes(load_config(PARITY, list(base)).model)
    assert shapes["edge_predictor/Dense_0/kernel"] == (3, 16)
    assert shapes["vertex_predictor/final_layer/kernel"] == (1024, 32)
    model.load_state_dict(params_from_flax(_params(SMALL[:-1])), strict=True)
    x = _cloud(2)
    perm = np.random.default_rng(3).permutation(x.shape[1])
    with torch.no_grad():
        a = model.eval()(torch.from_numpy(x))
        b = model(torch.from_numpy(x[:, perm]))
    np.testing.assert_allclose(a["vertices"].numpy(), b["vertices"].numpy(),
                               **F32)


def _train_cfg(tmp_path, *extra):
    return load_config(PARITY, list(SMALL) + [
        "model.compute_dtype=float32", "train.batch_size=3",
        "train.log_every=1", f"train.checkpoint_dir={tmp_path}", *extra])


def _flat_state(state, cfg):
    out = {f"p/{k}": v for k, v in
           state_dict_to_flax(state.params, cfg.model).items()}
    for name, d in (("mu", state.mu), ("nu", state.nu)):
        out.update({f"{name}/{k}": v for k, v in
                    state_dict_to_flax(d, cfg.model).items()})
    return out


def test_checkpoint_resume_is_deterministic(tmp_path):
    """The parity regime (overfit one batch, remat chain, MLP head,
    matcher "device", device augmentation on) for 6 epochs with
    checkpoint_every 3: one mid-run checkpoint, `step_3`, holding params,
    Adam moments and count, step and epoch, which serves as a port
    checkpoint.  Resuming it twice gives the same 3 losses and the same
    final state, bit for bit; the metrics go to train_metrics.jsonl."""
    cfg = _train_cfg(tmp_path, "train.num_epochs=6",
                     "train.checkpoint_every=3")
    batch = make_box_building_batch(cfg, 3, seed=0)
    writer = MetricWriter(str(tmp_path / "train_metrics.jsonl"))
    state = train_model(cfg, [batch], metric_writer=writer, device="cpu")
    assert state.step == 6 and latest_step(str(tmp_path)) == 3
    rows = [json.loads(line) for line in
            open(tmp_path / "train_metrics.jsonl")]
    assert rows == writer.history and [r["epoch"] for r in rows] == list(
        range(6))
    assert {"total_loss", "vertex_rmse", "hungarian_rmse", "learning_rate",
            "best_loss", "train_edge_f1"} <= set(rows[0])
    assert all(np.isfinite(r["total_loss"]) for r in rows)

    payload, meta = load_checkpoint(str(tmp_path))
    assert (meta["step"], meta["epoch"], payload["count"]) == (3, 3, 3)
    assert meta["max_vertices"] == 8 and meta["config"]["model"][
        "vertex_head"] == "mlp"
    assert set(payload["params"]) == set(payload["mu"]) == set(
        flax_param_shapes(cfg.model))
    assert "ema" not in payload and not os.path.exists(
        tmp_path / "step_3" / "ema.npz")
    served = apply_checkpoint_model_config(load_config(None), meta)
    assert served.model.vertex_head == "mlp"
    assert served.model.encoder_hidden_dims == (32, 64)

    runs = []
    for _ in range(2):
        fresh = create_train_state(cfg, init_model(cfg, "cpu", seed=5))
        fresh, start = restore_train_state(fresh, str(tmp_path))
        assert (start, fresh.step) == (3, 3)
        w = MetricWriter()
        final = train_model(cfg, [batch], metric_writer=w, state=fresh,
                            start_epoch=start, device="cpu")
        assert final.step == 6
        runs.append(([r["total_loss"] for r in w.history],
                     _flat_state(final, cfg)))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 3
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(v, runs[1][1][k], err_msg=k)


def test_epoch_mode_names_checkpoints_by_step_and_keeps_ema(tmp_path):
    """Two batches an epoch: the checkpoint after epoch 2 is step_4 with
    epoch 2 in its metadata.  As in the JAX package, it holds no EMA, and
    a restore restarts the EMA from the restored params (the trained
    run's EMA had moved away from them)."""
    cfg = _train_cfg(tmp_path, "train.num_epochs=3",
                     "train.checkpoint_every=2",
                     "train.overfit_one_batch=false", "train.ema_decay=0.9")
    loader = [make_box_building_batch(cfg, 3, seed=s) for s in (0, 1)]
    state = train_model(cfg, loader, device="cpu")
    assert state.step == 6 and latest_step(str(tmp_path)) == 4
    payload, meta = load_checkpoint(str(tmp_path))
    assert (meta["step"], meta["epoch"]) == (4, 2)
    assert sorted(os.listdir(tmp_path / "step_4")) == [
        "config.json", "opt_state.npz", "params.npz"]
    fresh = create_train_state(cfg, init_model(cfg, "cpu"))
    fresh, start = restore_train_state(fresh, str(tmp_path))
    assert (start, fresh.step) == (2, 4)
    ema = state_dict_to_flax(fresh.ema_params, cfg.model)
    for k, v in payload["params"].items():
        np.testing.assert_array_equal(ema[k], v, err_msg=k)
    trained_ema = state_dict_to_flax(state.ema_params, cfg.model)
    assert any(not np.array_equal(trained_ema[k], v)
               for k, v in state_dict_to_flax(state.params,
                                              cfg.model).items())


def test_init_from_warm_starts_params_only(tmp_path):
    """train.init_from: params from the latest checkpoint, a fresh Adam
    state and step, the EMA re-seeded from the loaded weights; another
    architecture raises."""
    pre = tmp_path / "pre"
    cfg = _train_cfg(pre, "train.num_epochs=3", "train.checkpoint_every=2")
    batch = make_box_building_batch(cfg, 3, seed=0)
    train_model(cfg, [batch], device="cpu")
    payload, _ = load_checkpoint(str(pre))
    warm = _train_cfg(tmp_path / "warm", "train.num_epochs=0",
                      f"train.init_from={pre}", "train.ema_decay=0.99")
    state = train_model(warm, [batch], device="cpu")
    assert state.step == 0
    got = state_dict_to_flax(state.params, warm.model)
    ema = state_dict_to_flax(state.ema_params, warm.model)
    for k, v in payload["params"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(ema[k], v, err_msg=k)
    assert all(float(m.abs().max()) == 0.0 for m in state.mu.values())
    other = load_config(PARITY, list(SMALL) + [
        "model.encoder_hidden_dims=16,64", "train.num_epochs=0",
        f"train.init_from={pre}"])
    with pytest.raises(ValueError, match="init_from"):
        train_model(other, [batch], device="cpu")


def test_mlp_checkpoint_serves(tmp_path):
    """A trained MLP-head checkpoint directory serves through
    WireframePredictor(device="cpu"): finite world-frame wireframes, and
    the served model's outputs equal the trained model's."""
    from wireframe_tpu_torch.serve import WireframePredictor

    cfg = _train_cfg(tmp_path, "train.num_epochs=2",
                     "train.checkpoint_every=1")
    batch = make_box_building_batch(cfg, 3, seed=0)
    train_model(cfg, [batch], device="cpu")
    path = str(tmp_path / "step_1")
    predictor = WireframePredictor(path, overrides=["data.point_buckets=64"],
                                   serve_batch_size=2, device="cpu")
    assert predictor.cfg.model.vertex_head == "mlp"
    offset = np.array([534000.0, 6588000.0, 40.0])
    rng = np.random.default_rng(1)
    clouds = []
    for n in (50, 90):
        raw, _ = box_building_cloud(rng, n)
        raw[:, :3] += offset
        clouds.append(raw)
    out = predictor.predict(clouds)
    for r in out:
        assert np.isfinite(r["vertices"]).all()
        assert r["num_vertices"] <= 8
        if r["num_vertices"]:
            assert np.linalg.norm(r["vertices"].mean(0) - offset) < 100
        if r["num_edges"]:
            assert r["edges"].max() < r["num_vertices"]
    fresh = create_train_state(cfg, init_model(cfg, "cpu", seed=9))
    trained, _ = restore_train_state(fresh, str(tmp_path), step=1)
    x = predictor.batch_array([predictor._preprocess(c)["pc"]
                               for c in clouds], 64)
    with torch.no_grad():
        a = predictor.model(torch.from_numpy(x))
        b = trained.model.eval()(torch.from_numpy(x))
    for key in ("vertices", "existence_probabilities", "edge_probs"):
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())


def test_resume_restarts_the_ema_as_the_jax_package_does(tmp_path):
    """A 2-epoch run (checkpoint after epoch 1), resumed by each package's
    rule from the same checkpoint: the JAX `main.py --resume` restores
    params and Adam state and re-seeds the EMA from the restored params
    (main.py:155-159); the port's `restore_train_state` does the same.
    After the first resumed step both EMAs are d * restored + (1 - d) *
    updated params, and they agree within the train tests' bound of
    2 * lr (tests/test_torch_train.py)."""
    from wireframe_tpu.train.state import create_train_state as jax_state
    from wireframe_tpu.train.step import make_train_step as jax_step
    from wireframe_tpu_torch.train.step import make_train_step

    extra = ["train.num_epochs=2", "train.checkpoint_every=1",
             "train.ema_decay=0.9", "train.batch_size=2",
             "model.attn_dropout=0", "model.edge_dropout=0",
             "train.device_augment=false"]
    cfg = _train_cfg(tmp_path, *extra)
    batch = make_box_building_batch(cfg, 2, seed=0)
    train_model(cfg, [batch], device="cpu")
    payload, _ = load_checkpoint(str(tmp_path), step=1)
    d, lr = cfg.train.ema_decay, cfg.train.learning_rate

    state = create_train_state(cfg, init_model(cfg, "cpu", seed=5))
    state, start = restore_train_state(state, str(tmp_path), step=1)
    assert (start, state.step) == (1, 1)
    restored = state_dict_to_flax(state.params, cfg.model)
    for k, v in state_dict_to_flax(state.ema_params, cfg.model).items():
        np.testing.assert_array_equal(v, restored[k], err_msg=k)
    state, _ = make_train_step(cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    got_p = state_dict_to_flax(state.params, cfg.model)
    got_e = state_dict_to_flax(state.ema_params, cfg.model)

    jcfg = jax_load_config(PARITY, list(SMALL) + [
        "model.compute_dtype=float32", f"train.checkpoint_dir={tmp_path}",
        *extra])
    jstate = jax_state(jcfg, jax.random.PRNGKey(0), (2, 64, 8))
    opt = list(jstate.opt_state)
    opt[2] = opt[2]._replace(count=jnp.asarray(payload["count"], jnp.int32),
                             mu=_nested(payload["mu"]),
                             nu=_nested(payload["nu"]))
    params = _nested(payload["params"])
    jstate = jstate.replace(step=jnp.asarray(payload["count"]),
                            params=params, opt_state=tuple(opt),
                            ema_params=jax.tree_util.tree_map(jnp.array,
                                                              params))
    jstate, _ = jax.jit(jax_step(jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    want_p = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params))
    want_e = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                   jstate.ema_params))
    for k, v in payload["params"].items():
        for p, e in ((got_p[k], got_e[k]), (want_p[k], want_e[k])):
            np.testing.assert_allclose(e, d * v + (1 - d) * p, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got_e[k], want_e[k], rtol=0,
                                   atol=2 * lr + 1e-6, err_msg=k)
