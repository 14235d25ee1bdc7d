"""The port's `viz` and `python -m wireframe_tpu_torch.visualize` against
the JAX package's `wireframe_tpu.viz` and the repository's `visualize.py`.

- Each of the five plot functions, on the same arrays, draws what the
  JAX one draws, compared by the artists' data (titles, axis labels and
  scales, 3D scatter offsets, sizes and colours, 3D line vertices,
  2D line data, histogram bar heights, legend texts), never by PNG
  bytes.
- The CLI against `visualize.py` run in this process on one set of
  bridged weights (the recipe at a small width in f32, random biases and
  slot queries so that the outputs spread), on a generated corpus of
  three test clouds, with `--loss-curve`: the same files, and the same
  decoded wireframes handed to `plot_prediction_comparison` (vertices
  atol 1e-5, edges equal) and the same masked edge probabilities (atol
  1e-5).  The edge threshold sits in the widest gap of the port's edge
  probabilities, and every probability and existence value is checked to
  stand 1e-4 or more from its threshold, so that f32 noise cannot flip a
  decision.  The JAX side runs its encoder's plain XLA reference, the
  port the K1 wrapper's plain version, as tests/test_torch_eval.py does.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import wireframe_tpu.viz as jax_viz
import wireframe_tpu_torch.viz as port_viz
from wireframe_tpu.config import config_to_dict as jax_config_to_dict
from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.train import checkpoint as jax_checkpoint
from wireframe_tpu.train.state import create_train_state as jax_state
from wireframe_tpu_torch import visualize as visualize_cli
from wireframe_tpu_torch.bridge import flatten_params
from wireframe_tpu_torch.config import config_to_dict, load_config
from wireframe_tpu_torch.data.building3d import (
    Building3DDataset,
    collate_fixed,
)
from wireframe_tpu_torch.eval.evaluator import build_model
from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main
from wireframe_tpu_torch.train import checkpoint
from wireframe_tpu_torch.train.step import make_forward_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=12", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=64",
         "model.pallas_chain_tile=32", "data.num_points=128",
         "model.compute_dtype=float32"]
MARGIN = 1e-4


def _artists(fig):
    """Everything a figure draws, as comparable data."""
    out = []
    for ax in fig.axes:
        a = {"title": ax.get_title(), "xlabel": ax.get_xlabel(),
             "ylabel": ax.get_ylabel(), "yscale": ax.get_yscale(),
             "collections": [], "lines": [], "bars": [],
             "legend": None}
        if hasattr(ax, "get_zlabel"):
            a["zlabel"] = ax.get_zlabel()
        for c in ax.collections:
            a["collections"].append({
                "offsets": np.asarray(getattr(c, "_offsets3d",
                                              c.get_offsets())),
                "sizes": np.asarray(c.get_sizes()),
                "array": (None if c.get_array() is None
                          else np.asarray(c.get_array())),
                "cmap": c.get_cmap().name,
                "label": c.get_label()})
        for line in ax.lines:
            data = (line.get_data_3d() if hasattr(line, "get_data_3d")
                    else line.get_xydata())
            a["lines"].append({"data": np.asarray(data),
                               "color": line.get_color(),
                               "width": line.get_linewidth(),
                               "style": line.get_linestyle(),
                               "label": line.get_label()})
        for p in ax.patches:
            a["bars"].append((p.get_x(), p.get_width(), p.get_height(),
                              p.get_facecolor()))
        if ax.get_legend() is not None:
            a["legend"] = [t.get_text() for t in ax.get_legend().get_texts()]
        out.append(a)
    return out


def _assert_same(got, want, where="figure"):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _plot_args(name, rng):
    verts = rng.normal(size=(6, 3))
    edges = np.array([[0, 1], [1, 2], [3, 4]])
    return {
        # Above max_points / 4000: both subsample with one seed.
        "plot_point_cloud": ((rng.normal(size=(5200, 8)),),
                             {"title": "cloud"}),
        "plot_wireframe": ((verts, edges), {"color": "tab:orange"}),
        "plot_prediction_comparison": (
            (rng.normal(size=(4100, 8)), verts, edges, verts + 0.1,
             edges[:2]),
            {"metrics": {"corners_f1": 0.5, "edges_f1": 0.25,
                         "average_corner_offset": 0.1}}),
        "plot_training_loss": (
            ([{"epoch": i, "total_loss": 1.0 / (i + 1), "vertex_loss": 0.5,
               "existence_loss": 0.2, "edge_loss": 0.1}
              for i in range(5)],), {}),
        "plot_edge_probabilities": ((rng.random(100),),
                                    {"threshold": 0.4}),
    }[name]


@pytest.mark.parametrize("name", port_viz.__all__)
def test_plot_draws_what_the_jax_plot_draws(name, tmp_path):
    import matplotlib.pyplot as plt

    args, kw = _plot_args(name, np.random.default_rng(0))
    got = getattr(port_viz, name)(*args, **kw)
    want = getattr(jax_viz, name)(*args, **kw)
    try:
        _assert_same(_artists(got), _artists(want))
        assert got.get_size_inches().tolist() == \
            want.get_size_inches().tolist()
    finally:
        plt.close(got)
        plt.close(want)
    path = tmp_path / "p.png"
    getattr(port_viz, name)(*args, **kw, save_path=str(path))
    assert path.stat().st_size > 1000


def _widest_gap(values, lo, hi):
    v = np.sort(values[(values > lo) & (values < hi)])
    i = int(np.argmax(np.diff(v)))
    return float((v[i] + v[i + 1]) / 2)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """(corpus, port cfg, JAX cfg, flat params, thresholds overrides)."""
    tmp = tmp_path_factory.mktemp("viz")
    corpus = str(tmp / "corpus")
    gen_main(["--out", corpus, "--train", "2", "--test", "3", "--seed", "6"])
    overrides = SMALL + [f"data.root_dir={corpus}"]
    jcfg = jax_load_config(RECIPE, overrides
                           + ["model.use_pallas_encoder=false"])
    st = jax_state(jcfg, jax.random.PRNGKey(0), (1, 128, 8))
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, st.params))
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.3).astype(np.float32)
    flat["vertex_decoder/slot_queries"] = rng.normal(
        size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)

    # The port's outputs on the clouds the CLIs draw (one generator over
    # the split in order): thresholds with a margin.
    cfg = load_config(RECIPE, overrides)
    ds = Building3DDataset(cfg.data, "test")
    draw = np.random.default_rng(cfg.data.seed)
    clouds = collate_fixed([ds.get_sample(i, rng=draw, augment_on_host=False)
                            for i in range(len(ds))],
                           cfg.model.max_vertices)["point_clouds"]
    model = build_model(cfg, flat, "cpu")
    out = make_forward_fn(cfg)(model, torch.from_numpy(clouds))
    exist = out["existence_probabilities"].numpy().ravel()
    probs = out["edge_probs"].numpy()[out["pair_mask"].numpy()]
    vthresh = _widest_gap(exist, np.quantile(exist, 0.2),
                          np.quantile(exist, 0.8))
    live = probs[probs > 0]
    ethresh = _widest_gap(live, np.quantile(live, 0.2),
                          np.quantile(live, 0.8))
    assert np.abs(exist - vthresh).min() > MARGIN
    assert np.abs(probs - ethresh).min() > MARGIN
    sets = [f"eval.edge_confidence_thresh={ethresh!r}",
            f"eval.vertex_existence_thresh={vthresh!r}"]
    jcfg = jax_load_config(RECIPE, overrides + sets
                           + ["model.use_pallas_encoder=false"])
    return corpus, load_config(RECIPE, overrides + sets), jcfg, flat, sets


def _record(monkeypatch, module, calls):
    """Wrap `module`'s two per-sample plots to record their arguments."""
    for name in ("plot_prediction_comparison", "plot_edge_probabilities"):
        real = getattr(module, name)

        def rec(*args, _real=real, _name=name, **kw):
            calls.append((_name, args, kw))
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, rec, raising=False)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def test_visualize_cli_draws_the_jax_cli_s_wireframes(bridged, tmp_path,
                                                      monkeypatch):
    import importlib.util

    corpus, cfg, jcfg, flat, sets = bridged
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "jax_visualize_cli", os.path.join(ROOT, "visualize.py"))
    jax_visualize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_visualize)
    monkeypatch.setenv("WIREFRAME_XLA_CACHE", "")
    nested = {}
    for path, v in flat.items():
        node = nested
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint", lambda d, s: (
        {"params": nested}, {"config": jax_config_to_dict(jcfg)}))
    monkeypatch.setattr(checkpoint, "load_checkpoint", lambda d, s: (
        {"params": flat}, {"config": config_to_dict(cfg)}))
    ck = tmp_path / "ck"
    ck.mkdir()
    with open(ck / "train_metrics.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"epoch": i, "total_loss": 2.0 / (i + 1),
                                "vertex_loss": 0.5, "existence_loss": 0.3,
                                "edge_loss": 0.2}) + "\n")
    calls = {"jax": [], "port": []}
    _record(monkeypatch, jax_viz, calls["jax"])
    _record(monkeypatch, port_viz, calls["port"])
    argv = ["--config", RECIPE, "--data-root", corpus, "--checkpoint-dir",
            str(ck), "--loss-curve", "--samples", "all",
            *[a for o in SMALL + sets for a in ("--set", o)]]
    assert jax_visualize.main(argv + ["--out-dir", str(tmp_path / "jax"),
                                      "--set",
                                      "model.use_pallas_encoder=false"]) == 0
    assert visualize_cli.main(argv + ["--out-dir", str(tmp_path / "port"),
                                      "--device", "cpu"]) == 0

    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len(got) == 1 + 2 * 3, got
    assert len(calls["port"]) == len(calls["jax"]) == 2 * 3
    edges = 0
    for (name, g_args, g_kw), (_, w_args, w_kw) in zip(calls["port"],
                                                       calls["jax"]):
        if name == "plot_prediction_comparison":
            pc, gt_v, gt_e, pred_v, pred_e = g_args
            np.testing.assert_array_equal(pc, w_args[0])
            np.testing.assert_array_equal(gt_v, w_args[1])
            np.testing.assert_array_equal(gt_e, w_args[2])
            np.testing.assert_allclose(pred_v, np.asarray(w_args[3]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(pred_e, w_args[4])
            assert (os.path.relpath(g_kw["save_path"], tmp_path / "port")
                    == os.path.relpath(w_kw["save_path"], tmp_path / "jax"))
            assert set(g_kw["metrics"]) == set(w_kw["metrics"])
            for k, w in w_kw["metrics"].items():
                np.testing.assert_allclose(g_kw["metrics"][k], w, rtol=1e-5,
                                           err_msg=k)
            edges += len(pred_e)
        else:
            np.testing.assert_allclose(g_args[0], np.asarray(w_args[0]),
                                       rtol=0, atol=1e-5)
            assert g_kw["threshold"] == w_kw["threshold"]
    assert edges > 0


def test_visualize_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        visualize_cli.main(["--checkpoint-dir", str(tmp_path / "ck"),
                            "--out-dir", str(tmp_path / "out")])
    assert os.listdir(tmp_path) == []
