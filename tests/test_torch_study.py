"""The port's study tools against the repository's `tools/`.

- `wireframe_tpu_torch.tools.study_report` prints the repository tool's
  output byte for byte on `SEED_STUDY_r05.jsonl` for explicit selectors;
  its one divergence (a control without a variant takes each treatment's
  variant) has a test that the repository's rule fails.
- `wireframe_tpu_torch.tools.seed_study` parses the port `evaluate`'s
  stdout, writes the final / ema / decoded records of a tiny CPU run, and
  guards the resume path's decoded re-evaluation as its fresh path.
- `wireframe_tpu_torch.tools.corpus_stats` returns the repository tool's
  dict on a generated corpus.

Tolerance: none; every comparison is exact (strings, dicts, floats
parsed from the same printed text).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from tools import corpus_stats as jax_corpus_stats
from tools import seed_study as jax_seed_study
from tools import study_report as jax_report
from wireframe_tpu_torch.tools import corpus_stats, seed_study, study_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R05 = os.path.join(ROOT, "SEED_STUDY_r05.jsonl")
# The small widths the port's CPU checks use (a few layers, narrow).
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "model.edge_hidden_dim=32", "model.edge_num_heads=4",
         "data.num_points=128", "model.compute_dtype=float32",
         "train.batch_size=2"]


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("control, tags", [
    ("recipe_r4b:ema", "cotrain2:ema"),
    ("recipe_r4b:final", "cotrain2,cotrain2:ema,pretrain3_ft:final"),
    ("recipe_r4b:decoded", "cotrain2:decoded,pretrain3_ft:decoded"),
    ("cotrain2:ema", "recipe_r4b:ema,recipe_r4b:final,missing:ema"),
])
def test_study_report_prints_the_repository_tools_tables(control, tags):
    argv = ["--results", R05, "--control", control, "--tags", tags]
    want = _stdout(jax_report.main, argv)
    got = _stdout(study_report.main, argv)
    assert got == want
    assert "Paired vs control" in got


def _rows(tmp_path, rows):
    path = tmp_path / "results.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def _rec(tag, seed, variant, edge_f1):
    return {"tag": tag, "seed": seed, "variant": variant,
            "edge_f1": edge_f1, "wed": 0.4, "corner_f1": 0.5, "aco": 0.2}


def test_control_without_variant_pairs_each_treatment_by_its_variant(
        tmp_path):
    # The control's final and ema rows differ; the treatment is ema only.
    path = _rows(tmp_path, [
        _rec("ctl", 0, "final", 0.50), _rec("ctl", 1, "final", 0.50),
        _rec("ctl", 0, "ema", 0.70), _rec("ctl", 1, "ema", 0.80),
        _rec("trt", 0, "ema", 0.75), _rec("trt", 1, "ema", 0.90),
        _rec("trt", 0, "final", 0.40), _rec("trt", 1, "final", 0.60),
    ])
    argv = ["--results", path, "--control", "ctl", "--tags",
            "trt:ema,trt"]
    out = _stdout(study_report.main, argv)
    # trt:ema - ctl:ema = +0.05/+0.10; trt:final - ctl:final = -0.10/+0.10
    ema_line = [ln for ln in out.splitlines()
                if ln.startswith("| trt (ema) | E-F1 |")][0]
    assert "+0.050/+0.100" in ema_line, out
    final_line = [ln for ln in out.splitlines()
                  if ln.startswith("| trt (final) | E-F1 |")][0]
    assert "-0.100/+0.100" in final_line, out
    # The header names the pairing, and the summary lists both controls.
    assert ("Paired vs control `ctl:ema` (n=2 seeds; the control's "
            "variant follows the treatment's):") in out
    assert "Paired vs control `ctl:final` (n=2 seeds; the control's" in out
    assert "| ctl (final) | 2 |" in out and "| ctl (ema) | 2 |" in out
    # The repository's rule pairs trt:ema with ctl:final (+0.25/+0.40).
    jax_out = _stdout(jax_report.main, argv)
    assert "+0.250/+0.400" in jax_out
    assert "+0.250/+0.400" not in out


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    from wireframe_tpu_torch.tools.gen_demo_data import main as gen

    root = tmp_path_factory.mktemp("study") / "corpus"
    gen(["--out", str(root), "--train", "4", "--test", "2", "--seed", "0"])
    return str(root)


def _small_sets():
    return [a for s in SMALL for a in ("--set", s)]


@pytest.fixture(scope="module")
def tiny_study(tiny_corpus, tmp_path_factory):
    """One seed, one epoch, at the small widths on the CPU, with every
    variant and its checkpoints kept: (argv, out dir, stdout)."""
    out = tmp_path_factory.mktemp("study") / "out"
    argv = ["--data-root", tiny_corpus, "--out", str(out), "--seeds", "0",
            "--tag", "tiny", "--eval-ema", "--decoded", "--keep-checkpoints",
            "--device", "cpu", "--set", "train.num_epochs=1",
            *_small_sets()]
    return argv, out, _stdout(seed_study.main, argv)


def test_seed_study_on_the_cpu_writes_three_records(tiny_study):
    argv, out, text = tiny_study
    rows = [json.loads(ln) for ln in open(out / "results.jsonl")]
    assert [(r["tag"], r["seed"], r["variant"]) for r in rows] == [
        ("tiny", 0, "final"), ("tiny", 0, "ema"), ("tiny", 0, "decoded")]
    for r in rows:
        assert r["device"] == "cpu"
        assert {"edge_f1", "corner_f1", "wed", "aco"} <= set(r)
        assert all(np.isfinite(r[k]) for k in ("edge_f1", "wed"))
    assert rows[2]["vertex_thresh"] in (0.2, 0.3, 0.5, 0.7)
    assert rows[2]["edge_thresh"] in (0.2, 0.3, 0.4, 0.5)
    assert (out / "tiny_s0" / "ema").is_dir()
    assert "== tiny [final] over 1 seeds ==" in text
    # A rerun resumes: every record is there, nothing is run again.
    again = _stdout(seed_study.main, argv)
    assert "tiny seed 0: already recorded" in again
    assert len(open(out / "results.jsonl").readlines()) == 3


def test_parse_metrics_reads_the_port_evaluate_stdout(tiny_study,
                                                      tiny_corpus):
    from wireframe_tpu_torch import evaluate

    _, out, _ = tiny_study
    argv = ["--data-root", tiny_corpus, "--checkpoint-dir",
            str(out / "tiny_s0"), "--device", "cpu", "--pipelined",
            "--eval-batch", "2", *_small_sets(),
            # Thresholds at which the one-epoch model's corners count, so
            # the corner metrics are not a trivial 0.
            "--set", "eval.vertex_existence_thresh=0",
            "--set", "eval.edge_confidence_thresh=0",
            "--set", "eval.distance_thresh=100"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        calc = evaluate.run(argv)
    text = buf.getvalue()
    d = calc.summarize()
    got = seed_study.parse_metrics(text)
    assert got == jax_seed_study.parse_metrics(text)
    assert got == {short: float(d[key])
                   for key, short in seed_study._METRIC_KEYS.items()}
    assert got["corner_f1"] > 0 and got["aco"] > 0, got


def test_resume_guards_a_failing_decoded_calibration(tmp_path, monkeypatch,
                                                     capsys):
    out = tmp_path / "study"
    out.mkdir()
    rows = []
    for seed in (0, 1):
        (out / f"g_s{seed}").mkdir()          # a kept checkpoint dir
        rows += [{**_rec("g", seed, v, 0.5), "train_s": 1.0}
                 for v in ("final", "ema")]
    (out / "results.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    calls = []

    def fake_decoded(args, seed, ckdir, results_path, train_s):
        calls.append(seed)
        if seed == 0:
            raise RuntimeError("calibration made to fail")

    monkeypatch.setattr(seed_study, "_eval_decoded", fake_decoded)
    rc = seed_study.main(["--out", str(out), "--seeds", "0,1", "--tag", "g",
                          "--eval-ema", "--decoded", "--device", "cpu"])
    assert rc == 0
    assert calls == [0, 1]          # seed 1 went on after seed 0 failed
    text = capsys.readouterr().out
    assert ("WARNING: decoded eval failed for g seed 0: calibration made "
            "to fail") in text


def test_corpus_stats_equals_the_repository_tools(tiny_corpus, tmp_path):
    for split in ("train", "test"):
        assert corpus_stats.corpus_stats(tiny_corpus, split) == \
            jax_corpus_stats.corpus_stats(tiny_corpus, split)
    s = corpus_stats.corpus_stats(tiny_corpus, "train", sample=2)
    assert s == jax_corpus_stats.corpus_stats(tiny_corpus, "train", 2)
    assert s["n_buildings"] == 2 and s["n_corpus"] == 4
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    rows = _stdout(corpus_stats.main, ["--root", tiny_corpus,
                                       "--json", str(a)])
    assert rows == _stdout(jax_corpus_stats.main, ["--root", tiny_corpus,
                                                   "--json", str(b)])
    assert a.read_bytes() == b.read_bytes()
