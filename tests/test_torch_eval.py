"""The port's evaluator, pipelined eval and threshold calibration against
the JAX package's.

A JAX model at small width (the recipe, `configs/recommended.yaml`:
query head, existence slot masks; and the reference-parity model,
`configs/default.yaml`: MLP head, prefix slot masks), its params carried
into the port through `bridge.params_from_flax` (randomized biases), both
in f32 on the CPU, on a 4 + 3 building corpus from the generator.

- The edge threshold sits in the widest gap of the JAX model's edge
  probabilities, and the test first asserts that no edge or existence
  probability lies within 1e-4 of its threshold, so float noise between
  the packages (~1e-6) cannot flip a decision.
- JAX `evaluate_model` and the port's give equal metric dicts, sampled
  and raw points, with host and with device Hausdorff: the integer
  counters exactly, the float ones (corner distances, WED) to rtol 1e-5
  (they sum the two models' vertices, which differ by float noise).  Fed
  the JAX model's own predictions, the port's evaluator gives the JAX
  dict exactly.
- The port's pipelined counters equal its device-Hausdorff counters
  exactly, also with a forced qmax and a forced emax overflow, counted in
  `stats`.
- Calibration prints the same table as the JAX tool.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.data.building3d import Building3DDataset as JaxDataset
from wireframe_tpu.data.building3d import collate_fixed as jax_collate
from wireframe_tpu.eval.evaluator import evaluate_model as jax_evaluate
from wireframe_tpu.eval.evaluator import predict_bucketed as jax_bucketed
from wireframe_tpu.train.state import create_train_state as jax_state
from wireframe_tpu.train.step import make_forward_fn as jax_forward_fn
from wireframe_tpu_torch.bridge import flatten_params
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.data.building3d import Building3DDataset
from wireframe_tpu_torch.eval.evaluator import evaluate_model
from wireframe_tpu_torch.eval.pipeline import evaluate_corpus_pipelined
from wireframe_tpu_torch.metrics.ap_calculator import _COUNTER_KEYS
from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"recipe": os.path.join(ROOT, "configs", "recommended.yaml"),
           "parity": os.path.join(ROOT, "configs", "default.yaml")}
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=12", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=64",
         "model.pallas_chain_tile=32", "data.num_points=128",
         "model.compute_dtype=float32", "data.point_buckets=2048,4096,8192",
         "eval.batch_size=2"]
MARGIN = 1e-4
FLOAT_KEYS = ("distance", "wed", "average_corner_offset", "average_wed")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    gen_main(["--out", root, "--train", "4", "--test", "3", "--seed", "2"])
    return root


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _widest_gap(values, lo, hi):
    v = np.unique(values[(values > lo) & (values < hi)])
    gaps = np.diff(v)
    k = int(np.argmax(gaps))
    return float(np.float32((v[k] + v[k + 1]) / 2))


def _setup(corpus, name, extra=()):
    """(port cfg, JAX cfg, flat params, JAX tree) with the edge threshold
    in the widest gap of the JAX model's edge probabilities over the
    sampled and raw test clouds, after checking every margin."""
    overrides = SMALL + [f"data.root_dir={corpus}", *extra]
    # The JAX side runs its encoder's plain XLA reference (the same
    # parameter layout); the port's runs the K1 wrapper's plain version.
    jcfg = jax_load_config(CONFIGS[name], overrides
                           + ["model.use_pallas_encoder=false"])
    st = jax_state(jcfg, jax.random.PRNGKey(0), (1, 128, 8))
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, st.params))
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.3).astype(np.float32)
    if "vertex_decoder/slot_queries" in flat:
        flat["vertex_decoder/slot_queries"] = rng.normal(
            size=flat["vertex_decoder/slot_queries"].shape).astype(
                np.float32)
    tree = _nested(flat)

    jds = JaxDataset(jcfg.data, "test")
    samples = [jds.get_sample(i, rng=np.random.default_rng(
        (jcfg.data.seed, i)), augment_on_host=False) for i in range(3)]
    fwd = jax.jit(jax_forward_fn(jcfg))
    out = fwd(tree, jnp.asarray(jax_collate(
        samples, jcfg.model.max_vertices)["point_clouds"]), None)
    exist = [np.asarray(out["existence_probabilities"]).ravel()]
    probs = [np.asarray(out["edge_probs"]).ravel()]
    jcfg.data.num_points = 0
    raw = [jds.get_sample(i, augment_on_host=False)["point_clouds"]
           for i in range(3)]
    jcfg.data.num_points = 128
    for r in jax_bucketed(jcfg, tree, raw):
        exist.append(r["existence"])
        probs.append(r["edge_probs"])
    exist, probs = np.concatenate(exist), np.concatenate(probs)
    live = probs[probs > 0]
    ethresh = _widest_gap(live, np.quantile(live, 0.2),
                          np.quantile(live, 0.8))
    assert np.abs(exist - 0.5).min() > MARGIN
    assert np.abs(probs - ethresh).min() > MARGIN
    assert (probs > ethresh).sum() > 10 and (exist > 0.5).sum() > 10
    sets = [f"eval.edge_confidence_thresh={ethresh!r}"]
    cfg = load_config(CONFIGS[name], overrides + sets)
    jcfg.eval.edge_confidence_thresh = ethresh
    return cfg, jcfg, flat, tree


def _assert_metrics_equal(got, want, rtol=1e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        if k in FLOAT_KEYS:
            np.testing.assert_allclose(got[k], w, rtol=rtol, err_msg=k)
        elif k in _COUNTER_KEYS:
            assert got[k] == w, k
        else:       # ratios of the integer counters
            np.testing.assert_allclose(got[k], w, rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("name,extra", [
    ("recipe", ()), ("recipe", ("eval.live_corner_filter=true",)),
    ("parity", ())])
def test_evaluate_model_matches_jax(corpus, name, extra):
    cfg, jcfg, flat, tree = _setup(corpus, name, extra)
    ds, jds = Building3DDataset(cfg.data, "test"), JaxDataset(jcfg.data,
                                                              "test")
    for kw in (dict(), dict(device_hausdorff=True), dict(raw_points=True)):
        got = evaluate_model(cfg, flat, ds, verbose=False, device="cpu",
                             **kw)
        want = jax_evaluate(jcfg, tree, jds, verbose=False, **kw)
        assert want["tp_fp_edges"] > 0 and want["tp_corners"] > 0, kw
        _assert_metrics_equal(got, want)

    # The JAX model's own predictions through the port's evaluator.
    fwd = jax.jit(jax_forward_fn(jcfg))

    def jax_forward(clouds):
        return {k: np.asarray(v) for k, v in
                fwd(tree, jnp.asarray(clouds), None).items()}

    got = evaluate_model(cfg, flat, ds, forward_fn=jax_forward,
                         verbose=False, device="cpu")
    assert got == jax_evaluate(jcfg, tree, jds, verbose=False)


def _counters(m):
    return {k: m[k] for k in m}


@pytest.mark.parametrize("name", ["recipe", "parity"])
def test_pipelined_counters_equal_device_hausdorff(corpus, name):
    cfg, _, flat, _ = _setup(corpus, name)
    ds = Building3DDataset(cfg.data, "test")
    want = evaluate_model(cfg, flat, ds, verbose=False, device_hausdorff=True,
                          device="cpu")
    assert want["tp_fp_edges"] > 0
    kw = dict(batch=cfg.eval.batch_size, device="cpu")
    for qmax, emax, q_over, e_over in ((64, 64, 0, 0), (1, 64, None, 0),
                                       (64, 2, 0, 3)):
        stats = {}
        got = evaluate_corpus_pipelined(cfg, flat, ds, qmax=qmax, emax=emax,
                                        stats=stats, **kw)
        assert got == want, (qmax, emax)
        assert stats["emax_overflows"] == e_over
        if q_over is None:
            assert stats["qmax_overflows"] >= 1
        else:
            assert stats["qmax_overflows"] == q_over


def test_calibration_prints_the_jax_table(corpus, tmp_path, capsys,
                                          monkeypatch):
    """Both tools on one checkpoint (an orbax one for JAX, a port one for
    the port, the same weights), one edge sweep on the train split and
    the test-split line: the same table."""
    sys.path.insert(0, ROOT)
    from tools.calibrate_threshold import main as jax_calibrate
    from wireframe_tpu.train.checkpoint import save_checkpoint as jax_save
    from wireframe_tpu_torch.eval.evaluator import build_model
    from wireframe_tpu_torch.tools.calibrate_threshold import (
        main as port_calibrate,
    )
    from wireframe_tpu_torch.train.checkpoint import save_params_checkpoint

    monkeypatch.setenv("WIREFRAME_XLA_CACHE", "")
    # 18 slots: the JAX tool's fixed qmax of 128 needs 128 pairs or more.
    wide = ("data.max_vertices=18",)
    cfg, jcfg, flat, tree = _setup(corpus, "recipe", wide)
    t = cfg.eval.edge_confidence_thresh
    jax_save(str(tmp_path / "jax"), 0, tree, None, jcfg)
    model = build_model(cfg, flat, "cpu")
    save_params_checkpoint(str(tmp_path / "port"), 0,
                           dict(model.named_parameters()), cfg)
    sets = [a for o in SMALL + list(wide) + ["model.use_pallas_encoder=false"]
            for a in ("--set", o)]
    argv = ["--config", CONFIGS["recipe"], "--data-root", corpus,
            "--param", "edge", "--thresholds", f"{t!r},0.999"] + sets
    tables = []
    for run, ck, extra in ((jax_calibrate, "jax", []),
                           (port_calibrate, "port", ["--device", "cpu"])):
        capsys.readouterr()
        assert run(argv + ["--checkpoint-dir", str(tmp_path / ck)]
                   + extra) == 0
        lines = capsys.readouterr().out.splitlines()
        tables.append([ln for ln in lines if ln.strip().startswith(
            ("thresh", "0.", "1.", "Best", "Sweeping", "Test split"))])
    assert len(tables[1]) == 8 and tables[0] == tables[1]
