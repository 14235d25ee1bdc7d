"""Finding a cell's files by name, spans, and the readings that the
per-layer metrics take.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in a file of its own, found by its name in
`BENCHMARK.json`:
- a configuration: the `file` of its `configs` entry;
- a traffic mix: `port_bench/traffic/<traffic>.json`, which names the
  driver (`port_bench/drivers/<driver>.py`) and its parameters;
- a per-layer metric: `port_bench/metrics/<name>.py`, a `read(reading)`
  that returns the value or None;
- a cell's correctness limits: `port_bench/limits/<workload>.json`.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    entry: Dict                      # the `workloads` entry
    config: Dict                     # the configuration file's contents
    traffic: Dict                    # the traffic file's contents
    end_to_end: List[Dict]           # the metrics this cell reports
    per_layer: List[Dict]
    limits: Dict[str, float]

    @property
    def model(self) -> Dict:
        return self.config["model"]


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    """The cell `workload` of `<root>/BENCHMARK.json` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    pkg = os.path.join(root, "port_bench")
    with open(os.path.join(pkg, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(pkg, "limits", workload + ".json")) as f:
        limits = json.load(f)
    return Cell(name=workload, entry=entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)],
                limits={k: float(v) for k, v in limits.items()
                        if not k.startswith("_")})


def driver_class(cell: Cell):
    module = importlib.import_module(
        "port_bench.drivers." + cell.traffic["driver"])
    return module.Driver


def metric_module(root: str, name: str):
    """`port_bench/metrics/<name>.py`, loaded by path (a metric's name may
    hold dots)."""
    path = os.path.join(root, "port_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spans:
    """The benchmark's own spans around its calls into the program, on the
    host clock, kept in memory.  While a segment is profiled each span is
    also a `record_function` range named "pb.<name>" in the trace."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.profiling:
            import torch

            with torch.profiler.record_function("pb." + name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str, since: float = 0.0,
                  until: float = float("inf")) -> List[float]:
        return [b - a for n, a, b in self.records
                if n == name and a >= since and b <= until]

    def dump(self) -> Optional[str]:
        """Write the spans as JSON under TMPDIR; returns the path."""
        import tempfile

        fd, path = tempfile.mkstemp(prefix="port_bench_spans_",
                                    suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(self.records, f)
        return path


@dataclass
class Reading:
    """What a per-layer metric's reader sees."""

    cell: Cell
    device_name: str
    window: Dict[str, Any]           # the driver's host-clock window stats
    spans: Spans
    segment: Any = None              # trace.Segment of the profiled part

    @property
    def model(self) -> Dict:
        return self.cell.model

    @property
    def dtype(self) -> str:
        return self.model["compute_dtype"]
