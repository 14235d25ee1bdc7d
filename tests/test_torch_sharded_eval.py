"""The port's sharded evaluation, its CLI and tools, and training on two
ranks through `torchrun`, on the CPU.

- `evaluate_model_sharded(n_shards=3)`, shard by shard and in one
  pipelined pass, gives counters `array_equal` to the unsharded run on
  the same path (the merge adds the samples' counters in dataset-index
  order, so the float counters are bit-identical too), and the metric
  dict of the JAX `evaluate_model_sharded` on the same bridged weights
  within tests/test_torch_eval.py's tolerance against the JAX evaluator
  (integer counters exactly, corner distances and WED rtol 1e-5; the
  model, corpus and thresholds of that file's `_setup`, whose margins
  keep float noise from flipping a decision).
- `evaluate --sharded 2 --device cpu` prints the plain run's metric
  lines.
- `tools.scale_eval --n 6 --shards 3` reports identical metrics, with
  the report keys of the repository's `tools/scale_eval.py` (read from
  its source).
- `torchrun --nproc_per_node 2 -m wireframe_tpu_torch.main --device cpu`
  with `parallel.dp=2`, 2 epochs of overfit on the recipe at small width
  (augmentation and dropout off; the spawned ranks of
  tests/test_torch_parallel.py hold the step with device augmentation
  on), on a corpus whose batch has targets near distinct predicted
  slots (`_targets_near_slots`): its `train_metrics.jsonl`
  equals a one-process run's (rtol 1e-5), one row per log point (rank 1
  writes none), and the two checkpoint directories hold the same files.
"""

import ast
import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_eval import SMALL, _assert_metrics_equal, _setup
from wireframe_tpu.data.building3d import Building3DDataset as JaxDataset
from wireframe_tpu.eval.distributed import (
    evaluate_model_sharded as jax_sharded,
)
from wireframe_tpu.train.step import make_forward_fn as jax_forward_fn
from wireframe_tpu_torch import evaluate as evaluate_cli
from wireframe_tpu_torch import main as main_cli
from wireframe_tpu_torch.bridge import params_from_flax
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.data.building3d import Building3DDataset
from wireframe_tpu_torch.data.loader import BatchLoader
from wireframe_tpu_torch.eval.distributed import (
    counters_vector,
    evaluate_model_sharded,
)
from wireframe_tpu_torch.eval.evaluator import evaluate_model
from wireframe_tpu_torch.eval.pipeline import evaluate_corpus_pipelined
from wireframe_tpu_torch.io.obj import save_wireframe
from wireframe_tpu_torch.metrics.ap_calculator import APCalculator
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.tools import scale_eval
from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main
from wireframe_tpu_torch.train.checkpoint import write_flax_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # tests/test_torch_eval.py's corpus: `_setup` checks its margins.
    root = str(tmp_path_factory.mktemp("corpus"))
    gen_main(["--out", root, "--train", "4", "--test", "3", "--seed", "2"])
    return root


@pytest.fixture(scope="module")
def recipe(corpus):
    return _setup(corpus, "recipe")


def _calc(cfg):
    return APCalculator(distance_thresh=cfg.eval.distance_thresh,
                        confidence_thresh=cfg.eval.edge_confidence_thresh)


@pytest.mark.parametrize("pipelined", [False, True])
def test_sharded_counters_equal_the_plain_run_and_jax(recipe, pipelined):
    cfg, jcfg, flat, tree = recipe
    ds = Building3DDataset(cfg.data, "test")
    plain, sharded = _calc(cfg), _calc(cfg)
    if pipelined:
        evaluate_corpus_pipelined(cfg, flat, ds, batch=2, ap=plain,
                                  device="cpu")
    else:
        evaluate_model(cfg, flat, ds, device_hausdorff=True, ap=plain,
                       verbose=False, device="cpu")
    got = evaluate_model_sharded(cfg, flat, ds, n_shards=3,
                                 device_hausdorff=True, pipelined=pipelined,
                                 pipeline_kwargs={"batch": 2}, ap=sharded,
                                 device="cpu")
    assert sharded.num_samples == 3
    np.testing.assert_array_equal(counters_vector(sharded),
                                  counters_vector(plain))

    fwd = jax.jit(jax_forward_fn(jcfg))
    want = jax_sharded(jcfg, tree, JaxDataset(jcfg.data, "test"), n_shards=3,
                       forward_fn=fwd,
                       device_hausdorff=True)
    assert want["tp_fp_edges"] > 0 and want["tp_corners"] > 0
    _assert_metrics_equal(got, want)


def _argv(corpus, ck, recipe_cfg):
    cfg = recipe_cfg[0]
    return (["--config", RECIPE, "--data-root", corpus, "--checkpoint-dir",
             ck, "--device", "cpu"]
            + [a for o in SMALL + [f"data.root_dir={corpus}",
                                   "eval.edge_confidence_thresh="
                                   f"{cfg.eval.edge_confidence_thresh!r}"]
               for a in ("--set", o)])


def test_evaluate_cli_sharded_prints_the_plain_metrics(corpus, recipe,
                                                       tmp_path):
    cfg, _, flat, _ = recipe
    ck = str(tmp_path / "ck")
    write_flax_checkpoint(ck, 1, flat, cfg)
    outs = []
    for extra in ([], ["--sharded", "2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert evaluate_cli.main(_argv(corpus, ck, recipe) + extra) == 0
        outs.append(buf.getvalue().splitlines())
    assert len(outs[0]) == 9 and outs[0] == outs[1]


def _jax_report_keys():
    """The keys the repository's tools/scale_eval.py writes into
    `report`, read from its source."""
    with open(os.path.join(ROOT, "tools", "scale_eval.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Name) and t.id == "report"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "report"):
                keys.add(t.slice.value)
    return keys


@pytest.mark.parametrize("legacy", [False, True])
def test_scale_eval_reports_identical_metrics(corpus, recipe, tmp_path,
                                              capsys, legacy):
    cfg, _, flat, _ = recipe
    ck = str(tmp_path / "ck")
    write_flax_checkpoint(ck, 1, flat, cfg)
    argv = (["--checkpoint-dir", ck, "--n", "6", "--shards", "3",
             "--corpus", str(tmp_path / "c6"), "--config", RECIPE,
             "--eval-batch", "2", "--reps", "1", "--device", "cpu",
             "--json", str(tmp_path / "r.json")]
            + [a for o in SMALL for a in ("--set", o)]
            + (["--legacy"] if legacy else []))
    assert scale_eval.main(argv) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["sharded_equals_unsharded"] is True
    assert report["n_buildings"] == 6 and report["device"] == "cpu"
    with open(tmp_path / "r.json") as f:
        assert json.load(f) == report
    optional = {"mismatch"} | ({"qmax_overflows"} if legacy else set())
    assert set(report) | optional == _jax_report_keys()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metrics(ck):
    with open(os.path.join(ck, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _files(ck):
    return sorted(os.path.relpath(os.path.join(d, n), ck)
                  for d, _, names in os.walk(ck) for n in names)


def _targets_near_slots(cfg, flat, root):
    """Rewrite the .obj files of the batch `main` overfits on the corpus at
    `root` so that its targets sit 0.05 from distinct slots the model of
    `flat` predicts (the dataset normalises by the cloud alone, so the
    clouds and the predictions do not move): the matching then has a
    clear margin.  On the generator's own targets the L1 costs tie
    exactly (two corners of a vertical edge share x and y; with both
    slots above them, swapping them changes no cost), and the rows'
    float noise picks one of the tied assignments (ROADMAP C1)."""
    loader = BatchLoader(Building3DDataset(cfg.data, "train"),
                         cfg.train.batch_size, cfg.model.max_vertices,
                         shuffle=True, drop_last=True, seed=cfg.train.seed,
                         augment_on_host=False)
    loader.epoch = 0                        # as train_model sets it
    batch = next(iter(loader))
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["point_clouds"]),
                     torch.from_numpy(batch["vertex_counts"]),
                     train=True)["vertices"].numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    for i, c in enumerate(batch["vertex_counts"]):
        slots = rng.permutation(pred.shape[1])[:c]
        verts = batch["wf_vertices"][i].astype(np.float64)
        verts[:c] = pred[i, slots] + rng.normal(size=(c, 3)) * 0.05
        save_wireframe(verts * batch["max_distance"][i] + batch["centroid"][i],
                       batch["wf_edges"][i], os.path.join(
                           root, "train", "wireframe",
                           f"{batch['scan_idx'][i]}.obj"))


def test_torchrun_two_ranks_train_as_one_process(recipe, tmp_path):
    root = str(tmp_path / "corpus")
    gen_main(["--out", root, "--train", "2", "--test", "1", "--seed", "4"])
    sets = SMALL + ["train.batch_size=2", "train.num_epochs=2",
                    "train.overfit_one_batch=true", "train.log_every=1",
                    "train.lr_schedule=constant", "model.attn_dropout=0",
                    "model.edge_dropout=0", "data.augment=false"]
    cfg = load_config(RECIPE, sets)
    cfg.data.root_dir = root
    flat = recipe[2]
    _targets_near_slots(cfg, flat, root)
    init = str(tmp_path / "init")
    write_flax_checkpoint(init, 0, flat, cfg)
    argv = (["--config", RECIPE, "--data-root", root, "--device", "cpu"]
            + [a for o in sets + [f"train.init_from={init}"]
               for a in ("--set", o)])
    one, two = str(tmp_path / "dp1"), str(tmp_path / "dp2")
    assert main_cli.main(argv + ["--checkpoint-dir", one,
                                 "--set", "parallel.dp=1"]) == 0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
         "--master_port", str(_free_port()), "-m", "wireframe_tpu_torch.main",
         *argv, "--checkpoint-dir", two, "--set", "parallel.dp=2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Data-parallel training: dp=2 ranks" in proc.stderr
    want, got = _metrics(one), _metrics(two)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    assert want[0]["total_loss"] != want[1]["total_loss"]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if k != "elapsed_time":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    assert _files(two) == _files(one)
