"""The port's CLIs with `--device cpu`: `python -m wireframe_tpu_torch.main`,
`.evaluate` and `.test`.

- `main` on a 4-building corpus (the recipe at small width, 2 epochs)
  writes `step_N`, `ema/step_N` and `train_metrics.jsonl`; `--resume` of
  the finished run leaves every file untouched; a bad `--data-root` gives
  the JAX CLI's SystemExit text.
- `evaluate` reads the checkpoint and prints the 8 metric lines;
  `--sharded` exits naming its ROADMAP item (`--torch-checkpoint` is
  held to the JAX evaluate.py in tests/test_torch_pth_import.py).
- `test` writes `.obj` files byte-equal to the JAX `test.py`'s from the
  same predictions (both packages' forwards replaced by one exact f32
  function of the cloud), in both slot-mask modes.
- Without a GPU and without `--device cpu`, every CLI raises before it
  writes anything.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from wireframe_tpu_torch import evaluate as evaluate_cli
from wireframe_tpu_torch import main as main_cli
from wireframe_tpu_torch import test as test_cli
from wireframe_tpu_torch.tools import calibrate_threshold
from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
PARITY = os.path.join(ROOT, "configs", "default.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=12", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=64",
         "model.pallas_chain_tile=32", "data.num_points=128",
         "model.compute_dtype=float32", "data.point_buckets=2048,4096,8192",
         "train.batch_size=2", "train.num_epochs=2",
         "train.checkpoint_every=1", "train.log_every=1"]
METRIC_LINES = ("Wireframe Edit distance", "Average Corner offset",
                "Corners Precision:", "Corners Recall:", "Corners F1:",
                "Edges Precision:", "Edges Recall:", "Edges F1:")


def _sets(overrides):
    return [a for o in overrides for a in ("--set", o)]


def _digest(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(dirpath, n), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4 + 2 building corpus and a 2-epoch recipe run on it."""
    tmp = tmp_path_factory.mktemp("cli")
    corpus = str(tmp / "corpus")
    gen_main(["--out", corpus, "--train", "4", "--test", "2", "--seed", "1"])
    ck = str(tmp / "ck")
    argv = ["--config", RECIPE, "--data-root", corpus, "--checkpoint-dir", ck,
            "--device", "cpu"] + _sets(SMALL)
    assert main_cli.main(argv + ["--debug-nans"]) == 0
    assert not torch.is_anomaly_enabled()
    return corpus, ck, argv


def test_main_writes_checkpoints_and_resume_touches_nothing(trained, capsys):
    corpus, ck, argv = trained
    names = set(os.listdir(ck))
    assert {"step_2", "step_2.meta.json", "step_4", "step_4.meta.json",
            "ema", "train_metrics.jsonl"} <= names
    assert sorted(os.listdir(os.path.join(ck, "ema"))) == [
        "step_4", "step_4.meta.json"]
    assert not os.path.exists(os.path.join(ck, "ema", "step_4",
                                           "opt_state.npz"))
    with open(os.path.join(ck, "step_4.meta.json")) as f:
        meta = json.load(f)
    assert (meta["step"], meta["epoch"]) == (4, 2)
    rows = [json.loads(line) for line in open(
        os.path.join(ck, "train_metrics.jsonl"))]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["total_loss"]) for r in rows)

    before = _digest(ck)
    capsys.readouterr()
    assert main_cli.main(argv + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "Resuming from epoch 2 (optimizer step 4)" in out
    assert "training already complete at epoch 2" in out
    assert _digest(ck) == before


def test_bad_data_root_gives_the_jax_message(tmp_path):
    sys.path.insert(0, ROOT)
    import main as jax_main

    bad = str(tmp_path / "nowhere")
    with pytest.raises(SystemExit) as want:
        jax_main.resolve_data_root(bad)
    with pytest.raises(SystemExit) as got:
        main_cli.main(["--data-root", bad, "--device", "cpu"])
    assert str(got.value) == str(want.value) and "Building3D layout" in str(
        got.value)


def test_evaluate_prints_the_metric_lines(trained, capsys):
    corpus, ck, _ = trained
    argv = ["--config", RECIPE, "--data-root", corpus, "--checkpoint-dir",
            os.path.join(ck, "ema"), "--device", "cpu"] + _sets(SMALL)
    capsys.readouterr()
    assert evaluate_cli.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Evaluating 2 samples from 'test'"
    for label in METRIC_LINES:
        hits = [ln for ln in out if ln.startswith(label)]
        assert len(hits) == 1, label
        assert np.isfinite(float(hits[0].split()[-1]))
    ap = evaluate_cli.run(argv + ["--step", "4", "--split", "train"])
    assert ap.num_samples == 4


@pytest.mark.parametrize("flag,item", [(["--sharded", "2"], "ROADMAP A7")])
def test_evaluate_refuses_unported_paths(flag, item):
    with pytest.raises(SystemExit, match=item):
        evaluate_cli.main(flag + ["--device", "cpu"])


def _fake_predictions(xp, pc, v):
    """Exact float32 predictions from a cloud (B, N, 8): the first v rows'
    xyz as vertices, their red channel as existence, products of two
    colour channels as edge probabilities."""
    from wireframe_tpu_torch.ops.pairs import triu_pairs_np

    pairs = triu_pairs_np(v)
    exist = pc[:, :v, 3]
    return {"vertices": pc[:, :v, :3],
            "existence_probabilities": exist,
            "edge_probs": pc[:, pairs[:, 0], 4] * pc[:, pairs[:, 1], 5],
            "actual_vertex_counts": xp.sum(exist > 0.5, axis=1).astype(
                xp.int32)}


@pytest.mark.parametrize("config", [RECIPE, PARITY],
                         ids=["recipe", "parity"])
def test_test_cli_writes_the_jax_obj_files(trained, tmp_path, monkeypatch,
                                           config):
    import importlib.util

    import jax.numpy as jnp

    # The repository's test.py by path: `import test` may find the
    # standard library's package.
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "jax_test_cli", os.path.join(ROOT, "test.py"))
    jax_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_test)
    from wireframe_tpu.config import config_to_dict as jax_config_to_dict
    from wireframe_tpu.config import load_config as jax_load_config
    from wireframe_tpu.train import checkpoint as jax_checkpoint
    from wireframe_tpu.train import step as jax_step
    from wireframe_tpu_torch.config import config_to_dict, load_config
    from wireframe_tpu_torch.eval import evaluator
    from wireframe_tpu_torch.train import checkpoint

    corpus = trained[0]
    overrides = SMALL + ["eval.batch_size=3"]
    jcfg = jax_load_config(config, overrides)
    cfg = load_config(config, overrides)
    v = cfg.model.max_vertices
    monkeypatch.setenv("WIREFRAME_XLA_CACHE", "")
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint", lambda d, s: (
        {"params": {}}, {"config": jax_config_to_dict(jcfg)}))
    monkeypatch.setattr(checkpoint, "load_checkpoint", lambda d, s: (
        {"params": {}}, {"config": config_to_dict(cfg)}))
    monkeypatch.setattr(jax_step, "make_forward_fn", lambda c, train: (
        lambda params, pc, counts: _fake_predictions(jnp, pc, v)))
    monkeypatch.setattr(evaluator, "make_forward_fn", lambda c, p, d: (
        lambda pc: _fake_predictions(np, pc, v)))
    argv = ["--config", config, "--data-root", corpus, "--split", "train",
            *_sets(overrides)]
    assert jax_test.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    assert test_cli.main(argv + ["--out-dir", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    got, want = _digest(tmp_path / "port"), _digest(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 4
    assert got == want
    edges = sum(b.count(b"\nl ") for b in got.values())
    verts = sum(b.count(b"v ") for b in got.values())
    assert edges > 0 and verts > 0


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_clis_raise_without_cuda(no_cuda, tmp_path):
    ck = str(tmp_path / "ck")
    for run in (main_cli.main, evaluate_cli.main, test_cli.main,
                calibrate_threshold.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(["--checkpoint-dir", ck, "--data-root", str(tmp_path)])
    assert os.listdir(tmp_path) == []
