"""The reference's own `.pth` in the port (`evaluate --torch-checkpoint`).

A state_dict in the reference model's layout at the reference's widths
(`configs/default.yaml`: encoder 8 -> 512 -> 1024 -> 2048 -> 1024 -> 512,
the MLP vertex head, max_vertices 64, edge head 512 / 8 heads), random
from a numpy seed (`utils.synth.reference_state_dict`), `torch.save`d:
- the port's transplant gives the flax tree of the JAX package's
  `load_torch_checkpoint_as_params`, array for array, and the same
  max_vertices;
- the port's parity model on that tree matches the flax model's forward
  within F32 (rtol 1e-5, atol 2e-5), both in f32 with the plain encoder;
- a state_dict without the lazily created `point_pool_proj` raises
  KeyError in both packages;
- `python -m wireframe_tpu_torch.evaluate --torch-checkpoint --device
  cpu` on a small generated corpus prints the JAX `evaluate.py
  --torch-checkpoint`'s metric lines, each value within rtol 1e-5 (the
  tolerance of tests/test_torch_eval.py: the two models' vertices differ
  by float noise).
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.train import checkpoint as jax_checkpoint
from wireframe_tpu_torch import evaluate as evaluate_cli
from wireframe_tpu_torch.bridge import flatten_params, params_from_flax
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main
from wireframe_tpu_torch.train import checkpoint
from wireframe_tpu_torch.utils.synth import reference_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(ROOT, "configs", "default.yaml")
F32 = dict(rtol=1e-5, atol=2e-5)
METRIC_LINES = ("Wireframe Edit distance", "Average Corner offset",
                "Corners Precision:", "Corners Recall:", "Corners F1:",
                "Edges Precision:", "Edges Recall:", "Edges F1:")


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pth") / "trained_model.pth")
    sd = reference_state_dict(load_config(PARITY), seed=0)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def test_transplant_equals_the_jax_transplant(pth):
    got, v = checkpoint.load_torch_checkpoint_as_params(pth)
    want, jv = jax_checkpoint.load_torch_checkpoint_as_params(pth)
    assert v == jv == 64
    got, want = flatten_params(got), flatten_params(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_forward_matches_flax(pth):
    from wireframe_tpu.config import load_config as jax_load_config
    from wireframe_tpu.models.wireframe import PointCloudToWireframe as Jax

    params, _ = checkpoint.load_torch_checkpoint_as_params(pth)
    flat = flatten_params(params)
    jcfg = jax_load_config(PARITY)
    cfg = load_config(PARITY)
    assert (cfg.model.vertex_head, cfg.model.compute_dtype,
            cfg.model.use_pallas_encoder) == ("mlp", "float32", False)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 256, 8)).astype(np.float32)
    x[1, 200:] = 0.0
    jm = Jax(jcfg.model)
    want = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, None,
                                          train=False))(_nested(flat),
                                                        jnp.asarray(x))
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for key in ("vertices", "existence_logits", "existence_probabilities",
                "edge_probs", "global_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **F32)
    np.testing.assert_array_equal(got["actual_vertex_counts"].numpy(),
                                  np.asarray(want["actual_vertex_counts"]))


def test_missing_point_pool_proj_raises_in_both(pth, tmp_path):
    sd = torch.load(pth, weights_only=True)
    for key in ("weight", "bias"):
        del sd[f"vertex_predictor.point_pool_proj.{key}"]
    path = str(tmp_path / "no_pool.pth")
    torch.save(sd, path)
    for package in (checkpoint, jax_checkpoint):
        with pytest.raises(KeyError, match="point_pool_proj"):
            package.load_torch_checkpoint_as_params(path)


def _metrics(text):
    out = {}
    for label in METRIC_LINES:
        hits = [ln for ln in text.splitlines() if ln.startswith(label)]
        assert len(hits) == 1, label
        out[label] = float(hits[0].split()[-1])
    return out


def test_evaluate_cli_prints_the_jax_metrics(pth, tmp_path, capsys,
                                             monkeypatch):
    corpus = str(tmp_path / "corpus")
    gen_main(["--out", corpus, "--train", "2", "--test", "3", "--seed",
              "2"])
    # The repository's evaluate.py by path, beside its main.py.
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_cli", os.path.join(ROOT, "evaluate.py"))
    jax_evaluate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_evaluate)
    monkeypatch.setenv("WIREFRAME_XLA_CACHE", "")
    argv = ["--config", PARITY, "--data-root", corpus, "--torch-checkpoint",
            pth, "--set", "data.num_points=512"]
    capsys.readouterr()
    assert jax_evaluate.main(argv) == 0
    want = _metrics(capsys.readouterr().out)
    assert evaluate_cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "Evaluating 3 samples from 'test'"
    got = _metrics(out)
    for label, w in want.items():
        assert np.isfinite(got[label]), label
        np.testing.assert_allclose(got[label], w, rtol=1e-5, err_msg=label)
