"""Every cell of BENCHMARK.json is found by name with its files."""

import json
import os

import pytest

from port_bench import harness

ROOT = os.path.dirname(harness.PACKAGE_DIR)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert cell.name == workload
    assert harness.driver_class(cell).__name__ == "Driver"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.limits


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_by_name(name):
    module = harness.metric_module(ROOT, name)
    assert callable(module.read)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", ["recipe", "parity"])
def test_config_file_is_the_shipped_yaml(name):
    """Each configuration file holds its source yaml as the program reads
    it, with only the keys under `changed` changed."""
    from wireframe_tpu_torch.config import config_to_dict, load_config

    conf = [c for c in BENCH["configs"] if c["name"] == name][0]
    with open(os.path.join(ROOT, conf["file"])) as f:
        data = json.load(f)
    sets = [f"{k}={v['to']}" for k, v in data["changed"].items()]
    shipped = config_to_dict(load_config(
        os.path.join(ROOT, data["source_file"]), sets))
    for sec, values in shipped.items():
        got = {k: (tuple(v) if isinstance(v, list) else v)
               for k, v in data[sec].items()}
        want = {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in values.items()}
        assert got == want, sec
    assert sorted(data["changed"]) == sorted(conf["reduced"])
