"""Whole runs of the cells, cut to a CPU size, without the look for a
card: sound runs come out correct; a cell added from new files alone
runs; the control in the program's place comes out not correct."""

import json
import os

import pytest

from port_bench.tests import tiny

WORKLOADS = ["parity-train-b128", "recipe-infer-b512",
             "recipe-train-b8", "recipe-serve-c1"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(root, workload, capsys):
    res = tiny.run(root, workload, capsys=capsys)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    want = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("workload", ["recipe-train-b8",
                                      "recipe-infer-b512",
                                      "recipe-serve-c1"])
def test_traced_run(root, workload, capsys):
    res = tiny.run(root, workload, trace=1, capsys=capsys)
    assert res["correct"]
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_from_new_files_only(root, capsys):
    """A configuration, a traffic mix, a limits file and entries in
    BENCHMARK.json: nothing else changes."""
    pkg = os.path.join(root, "port_bench")
    with open(os.path.join(pkg, "configs", "recipe.json")) as f:
        conf = json.load(f)
    conf["model"]["decoder_kv_pool"] = 2
    with open(os.path.join(pkg, "configs", "recipe-kv2.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pkg, "traffic", "infer-b2.json"), "w") as f:
        json.dump({"driver": "infer", "batch": 2, "pool": 2,
                   "in_flight": 2, "warm_calls": 1, "checked_calls": 2,
                   "traced_calls": 1}, f)
    with open(os.path.join(pkg, "limits", "recipe-kv2-infer-b2.json"),
              "w") as f:
        json.dump({k: v for k, v in tiny.LIMITS["forward"].items()
                   if k != "decode_gap"}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "recipe-kv2", "source": "test",
                             "file": "port_bench/configs/recipe-kv2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "recipe-kv2-infer-b2",
                               "config": "recipe-kv2",
                               "traffic": "infer-b2", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "recipe-infer-b512" in m.get("workloads", []):
            m["workloads"].append("recipe-kv2-infer-b2")
    with open(path, "w") as f:
        json.dump(bench, f)
    res = tiny.run(root, "recipe-kv2-infer-b2", capsys=capsys)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"infer_clouds_per_s", "setup_s"}


@pytest.mark.parametrize("workload", ["recipe-train-b8",
                                      "recipe-infer-b512",
                                      "recipe-serve-c1"])
def test_control_in_the_programs_place_is_not_correct(root, workload,
                                                      capsys, monkeypatch):
    """The reference in fp8 (the precision below the configuration's bf16)
    put in the program's place.  The float32 cell's control, TF32, acts
    only on the card: `test_pb_card.py`."""
    from port_bench import harness

    cls = harness.driver_class(harness.load_cell(root, workload))
    monkeypatch.setattr(cls, "program_numbers", cls.control_numbers)
    res = tiny.run(root, workload, capsys=capsys)
    assert not res["correct"], res["checks"]
