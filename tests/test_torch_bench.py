"""The port's bench and its helpers against the JAX package's.

- `model_flops_per_cloud` equals `bench.model_flops_per_cloud` exactly
  (the same integer arithmetic on the same config fields);
- `StepTimer.summary` equals the JAX `StepTimer`'s on the same tick times
  (`time.perf_counter` patched: both read it);
- `tree_size_bytes` of bridged params equals the JAX tree's;
- `train.step.make_forward_fn` matches `wireframe_tpu.train.step.
  make_forward_fn` on bridged weights at `tests/test_torch_model.py`'s
  tolerances: f32 rtol 1e-5 / atol 2e-5 (same arithmetic, other summation
  orders); bf16 vertices atol 5e-2 and probabilities 2e-2 (a few bf16
  ulps after ~30 roundings);
- the timing protocols the bench and the tools share (`chained_seconds`,
  `round_trips`, `staged_clouds`) call what they time as often as they
  say, and `card_samples` records nothing off the card;
- `python -m wireframe_tpu_torch.bench --device cpu` prints one JSON line
  in forward and train mode, with bench.py's keys but `vs_baseline`, and
  `mfu` null on the CPU; the card's peak comes from a table that refuses
  an unknown card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from wireframe_tpu.config import Config as JaxConfig
from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.models.wireframe import PointCloudToWireframe as JaxModel
from wireframe_tpu.train.step import make_forward_fn as jax_make_forward_fn
from wireframe_tpu.utils import profiling as jax_profiling
from wireframe_tpu.utils.trees import tree_size_bytes as jax_tree_size_bytes
from wireframe_tpu_torch import bench
from wireframe_tpu_torch.bridge import flatten_params, params_from_flax
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.train.state import create_train_state
from wireframe_tpu_torch.train.step import make_forward_fn
from wireframe_tpu_torch.utils import profiling
from wireframe_tpu_torch.utils.trees import tree_size_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=32"]
NARROW_YAML = """\
data: {max_vertices: 8, z_sort_points: true}
model:
  use_pallas_encoder: true
  chain_backward: stash
  vertex_head: query
  encoder_hidden_dims: [32, 64]
  encoder_output_dim: 32
  decoder_dim: 32
  decoder_layers: 2
  decoder_heads: 4
  decoder_ffn_dim: 64
  edge_hidden_dim: 32
  edge_num_heads: 4
  pallas_tile: 64
  pallas_chain_tile: 64
  slot_mask_mode: existence
  edge_use_slot_features: true
  decoder_kv_pool: 4
train: {matched_edge_labels: true, matched_existence_labels: true}
"""


@pytest.mark.parametrize("n_points", [2048, 2560, 16384])
@pytest.mark.parametrize("config", ["recipe", "parity"])
def test_model_flops_per_cloud_equals_bench_py(config, n_points):
    if config == "recipe":
        mine, theirs = load_config(RECIPE), jax_load_config(RECIPE)
    else:
        mine, theirs = load_config(None), JaxConfig()
    got = bench.model_flops_per_cloud(mine, n_points)
    assert got == jax_bench.model_flops_per_cloud(theirs, n_points)
    assert got > 2 * n_points * 5.2e6      # at least the encoder chain


@pytest.mark.parametrize("warmup,ticks", [
    (3, [0.0, 1.0, 1.5, 4.0, 4.25, 9.0, 9.5, 9.625]),
    (0, [10.0, 10.5, 12.0, 12.1, 20.0]),
    # Fewer intervals than the warmup: both fall back to all of them.
    (5, [0.0, 2.0, 2.5]),
    (3, [0.0]),                       # one tick: no interval, {}
])
def test_step_timer_summary_equals_jax(monkeypatch, warmup, ticks):
    import time

    summaries = []
    for module in (profiling, jax_profiling):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(warmup=warmup)
        for _ in ticks:
            timer.tick()
        summaries.append(timer.summary(items_per_step=4))
    assert summaries[0] == summaries[1]


def _jax_params(overrides):
    cfg = jax_load_config(RECIPE, overrides)
    model = JaxModel(cfg.model)
    x = jnp.zeros((1, 64, cfg.model.input_dim), jnp.float32)
    params = jax.jit(lambda key: model.init({"params": key}, x, None,
                                            train=False)["params"])(
        jax.random.PRNGKey(0))
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(7)
    for k, v in flat.items():          # nonzero biases, distinct slots
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    flat["vertex_decoder/slot_queries"] = rng.normal(
        size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return cfg, flat, tree


def test_tree_size_bytes_of_bridged_params_equals_jax():
    overrides = SMALL + ["model.compute_dtype=float32"]
    _, flat, tree = _jax_params(overrides)
    want = jax_tree_size_bytes(tree)
    model = PointCloudToWireframe(load_config(RECIPE, overrides).model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    state = create_train_state(load_config(RECIPE, overrides), model)
    assert want > 0
    assert tree_size_bytes(model.state_dict()) == want
    assert tree_size_bytes(state.params) == want
    assert tree_size_bytes(flat) == want                 # numpy leaves
    assert tree_size_bytes([state.params, None]) == want
    with pytest.raises(TypeError):
        tree_size_bytes({"a": 1.0})


def _cloud(seed, b=3, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 8)).astype(np.float32)
    x[0, 40:] = 0.0
    x[1, :6] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_forward_fn_matches_jax(dtype):
    overrides = SMALL + [f"model.compute_dtype={dtype}"]
    jcfg, flat, tree = _jax_params(overrides)
    x = _cloud(0 if dtype == "float32" else 1)
    want = jax.jit(jax_make_forward_fn(jcfg, train=False))(
        tree, jnp.asarray(x), None)
    cfg = load_config(RECIPE, overrides)
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    got = make_forward_fn(cfg)(model, torch.from_numpy(x))
    assert set(got) == set(want)
    assert all(t.is_inference() for t in got.values())
    if dtype == "float32":
        tols = {k: dict(rtol=1e-5, atol=2e-5) for k in (
            "vertices", "existence_logits", "existence_probabilities",
            "edge_probs", "edge_logits", "global_features")}
    else:
        tols = {"vertices": dict(rtol=0, atol=5e-2),
                "existence_probabilities": dict(rtol=0, atol=2e-2),
                "edge_probs": dict(rtol=0, atol=2e-2)}
    for key, tol in tols.items():
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   err_msg=key, **tol)


def _run_bench(monkeypatch, capsys, tmp_path, **env):
    yaml = tmp_path / "narrow.yaml"
    yaml.write_text(NARROW_YAML)
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    base = {"BENCH_CONFIG": str(yaml), "BENCH_BATCH": "2",
            "BENCH_POINTS": "128", "BENCH_ITERS": "2",
            "BENCH_LAT_ITERS": "2", "BENCH_DTYPE": "float32"}
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[-1])


BENCH_KEYS = {"metric", "value", "unit", "arch", "config", "batch", "points",
              "dtype", "device", "mean_batch_ms", "mfu", "param_bytes"}


def test_bench_forward_on_cpu(monkeypatch, capsys, tmp_path):
    r = _run_bench(monkeypatch, capsys, tmp_path, BENCH_BUCKETS="128,256",
                   BENCH_SWEEP="64,128")
    assert BENCH_KEYS | {"latency_ms", "parity_arch", "buckets", "sweep",
                         "forward_calls"} == set(r)
    assert "vs_baseline" not in r and r["mfu"] is None
    assert (r["metric"], r["device"], r["batch"], r["points"]) == (
        "clouds_per_sec_per_chip", "cpu", 2, 128)
    assert r["value"] > 0 and r["mean_batch_ms"] > 0
    assert set(r["latency_ms"]) == {"p50", "p90", "p99", "per_cloud_p50",
                                    "iters"}
    assert r["latency_ms"]["iters"] == 2
    assert r["latency_ms"]["p50"] <= r["latency_ms"]["p99"]
    assert r["parity_arch"]["max_vertices"] == 64
    assert r["parity_arch"]["mfu"] is None
    # A constant point budget per bucket, never below batch 8.
    assert {k: v["batch"] for k, v in r["buckets"].items()} == {
        "128": 8, "256": 8}
    assert set(r["sweep"]) == {"64", "128"}
    assert all(v["clouds_per_sec"] > 0 for v in r["sweep"].values())
    # warmup 5 + 2 timed, 2 + 2 latency, parity 5 + 2, buckets 2 x (2 + 2),
    # sweep 2 x (5 + 2).
    assert r["forward_calls"] == 7 + 4 + 7 + 8 + 14


def test_bench_train_on_cpu(monkeypatch, capsys, tmp_path):
    r = _run_bench(monkeypatch, capsys, tmp_path, BENCH_TRAIN="1")
    assert BENCH_KEYS | {"steps"} == set(r)
    assert r["metric"] == "train_clouds_per_sec_per_chip"
    assert r["steps"] == 7 and r["mfu"] is None and r["value"] > 0
    # f32 weights of the narrow recipe, as the model holds them.
    cfg = bench.bench_config(str(tmp_path / "narrow.yaml"), 128, "float32",
                             True)
    assert r["param_bytes"] == 4 * sum(
        p.numel() for p in PointCloudToWireframe(cfg.model).parameters())


def test_bench_profile_writes_a_chrome_trace(monkeypatch, capsys, tmp_path):
    r = _run_bench(monkeypatch, capsys, tmp_path,
                   BENCH_PARITY_SECONDARY="0",
                   BENCH_PROFILE=str(tmp_path / "prof"))
    assert "parity_arch" not in r
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


def test_bf16_peak_table(monkeypatch):
    assert bench.bf16_peak_flops(torch.device("cpu")) is None
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4e12),
                       ("NVIDIA H100 PCIe", 756e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None,
                            n=name: n)
        assert bench.bf16_peak_flops(torch.device("cuda")) == peak
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no bf16 peak"):
        bench.bf16_peak_flops(torch.device("cuda"))


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(4) @ torch.ones(4)
    assert len(list((tmp_path / "t").glob("*.json"))) == 1
    assert profiling.device_rows(prof) == []      # no card, no device rows


def test_chained_seconds_chains_every_call_and_traces_the_window(tmp_path):
    calls = []

    def call(s, i):
        calls.append(i)
        return s + 1.0

    secs = profiling.chained_seconds(call, 4, "cpu", warmup=3,
                                     profile_dir=str(tmp_path / "t"))
    assert calls == [0, 1, 2, 0, 1, 2, 3] and secs > 0
    # Only the timed window is traced.
    assert len(list((tmp_path / "t").glob("*.pt.trace.json"))) == 1


def test_round_trips_times_each_call(monkeypatch):
    import time

    clock = iter(float(t) for t in range(100))
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    calls = []
    s = profiling.round_trips(lambda i: calls.append(i), 5,
                              items_per_step=4)
    assert calls == [0, 1, 0, 1, 2, 3, 4]
    assert s["steps"] == 5 and s["p50_s"] == 1.0
    assert s["items_per_sec"] == 4.0


def test_staged_clouds_are_distinct_draws():
    xs = profiling.staged_clouds(np.random.default_rng(0), 2, 16, 8, 3, "cpu")
    assert [tuple(x.shape) for x in xs] == [(2, 16, 8)] * 3
    assert all(x.dtype == torch.float32 for x in xs)
    assert not torch.equal(xs[0], xs[1])
    again = profiling.staged_clouds(np.random.default_rng(0), 2, 16, 8, 1,
                                    "cpu")
    assert torch.equal(again[0], xs[0])


def test_card_samples_records_nothing_on_the_cpu():
    with profiling.card_samples("cpu") as card:
        pass
    assert card == {}


def test_card_samples_parses_and_stops_the_sampler(tmp_path, monkeypatch):
    """A stand-in nvidia-smi prints three samples (one malformed line
    among them) and then waits to be stopped."""
    import stat
    import sys

    fake = tmp_path / "nvidia-smi"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "for row in ('1980, 2619, 350.5, 40', 'N/A', '1755, 2619, 690.0, 44',"
        " '1830, 2619, 500.0, 42'):\n"
        "    print(row, flush=True)\n"
        "time.sleep(60)\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    import time

    t0 = time.perf_counter()
    with profiling.card_samples("cuda") as card:
        time.sleep(1.0)
    assert time.perf_counter() - t0 < 30          # stopped, not waited for
    assert card["samples"] == 3
    assert card["clocks.sm"] == pytest.approx([1755.0, 1855.0, 1980.0])
    assert card["power.draw"] == pytest.approx([350.5, 513.5, 690.0])
    assert card["temperature.gpu"] == [40.0, 42.0, 44.0]
