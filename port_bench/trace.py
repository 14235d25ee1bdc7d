"""The profiled segment: capture, parse, union, breakdown.

A traced run profiles only a short last segment of its work with
`torch.profiler` (CPU and CUDA activities), exports the Chrome trace into
a directory under TMPDIR, reads back every event that ran on the card (a
kernel, copy or memset) and the benchmark's own spans (`record_function`
names starting "pb."), and removes the directory.

Kernel names are grouped by a frozen copy of the port's `GROUPS` /
`classify` (`wireframe_tpu_torch/tools/trace_ops.py`).  `PORT_KERNELS`
lists every `__global__` symbol of the port's `csrc/`, so a port kernel
that no per-layer metric's list claims can be named.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Sequence, Tuple

from port_bench import stats

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pb."

GROUPS = (
    ("K4 (lockstep JV)", re.compile(r"lsa_kernel|lsa_block_kernel")),
    ("K1 (fused encoder)", re.compile(
        r"k1_finalize|wgmma_chain_kernel<0, 3")),
    ("K2/K3/K5 (encoder chain)", re.compile(
        r"wgmma_chain_kernel|prep_x_kernel|window_pool_kernel|seed_kernel"
        r"|colsum_kernel|ln_fwd_rows_kernel|ln_bwd_rows_kernel")),
    ("library GEMM (cuBLAS / CUTLASS)", re.compile(
        r"gemm|gemv|nvjet|cutlass|cublas|xmma|splitKreduce|dot_kernel",
        re.I)),
    ("attention / softmax", re.compile(
        r"softmax|attention|fmha|flash|sdpa", re.I)),
    ("copy / cast", re.compile(
        r"^Memcpy|^Memset|copy_kernel|direct_copy|CatArray|memcpy|memset",
        re.I)),
    ("elementwise / reduce", re.compile(
        r"elementwise|reduce|foreach|multi_tensor|norm|index|scatter"
        r"|gather|where|sort|scan|argmax|max_|sum_|fill", re.I)),
)

# Every __global__ function of wireframe_tpu_torch/csrc/.
PORT_KERNELS = ("wgmma_chain_kernel", "prep_x_kernel", "window_pool_kernel",
                "seed_kernel", "colsum_kernel", "k1_finalize_kernel",
                "ln_fwd_rows_kernel", "ln_bwd_rows_kernel", "lsa_kernel",
                "lsa_block_kernel")


def classify(name: str) -> str:
    for label, pat in GROUPS:
        if pat.search(name):
            return label
    return "other"


def matches(name: str, symbols: Sequence[str]) -> bool:
    """Whether a demangled kernel name is one of `symbols` (as a whole
    identifier: `lsa_kernel` does not match `lsa_block_kernel`)."""
    return any(re.search(r"(?<![A-Za-z0-9_])" + re.escape(s)
                         + r"(?![A-Za-z0-9_])", name) for s in symbols)


@dataclass
class Segment:
    """What a profiled segment saw, times in seconds on the trace's clock."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0
    units: int = 0                       # steps, batches or requests

    @property
    def wall(self) -> float:
        return self.end - self.start

    def intervals(self) -> List[Tuple[float, float]]:
        return [(a, b) for _, a, b in self.device]

    def busy(self) -> float:
        """Seconds in which some device event ran (the union)."""
        return stats.covered(self.intervals(), self.start, self.end)

    def seconds_of(self, symbols: Sequence[str]) -> float:
        """Summed device seconds of the kernels named by `symbols`."""
        return sum(b - a for n, a, b in self.device if matches(n, symbols))

    def by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.device:
            g = classify(n)
            out[g] = out.get(g, 0.0) + (b - a)
        return out

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest idle gaps, each named by the innermost benchmark
        span open on the host at its midpoint ("no span" otherwise)."""
        out = []
        for a, b in stats.gaps(self.intervals(), self.start, self.end):
            mid = 0.5 * (a + b)
            open_ = [(s1 - s0, n) for n, s0, s1 in self.spans
                     if s0 <= mid <= s1]
            name = min(open_)[1] if open_ else "no span"
            out.append([name, b - a])
        return sorted(out, key=lambda r: -r[1])[:top]


def parse_chrome(path: str) -> Segment:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    seg = Segment()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        a = float(ev.get("ts", 0.0)) * 1e-6
        b = a + float(ev.get("dur", 0.0)) * 1e-6
        if ev.get("cat") in DEVICE_CATEGORIES:
            seg.device.append((ev["name"], a, b))
        elif ev.get("cat") == "user_annotation" and str(
                ev.get("name", "")).startswith(SPAN_PREFIX):
            seg.spans.append((ev["name"][len(SPAN_PREFIX):], a, b))
    return seg


@contextlib.contextmanager
def profiled(result: List[Segment]) -> Iterator[None]:
    """Profile the block; append its Segment to `result`.  The segment's
    start and end are those of its outermost "pb.segment" span, which the
    block must open (`Spans.span("segment")`) and close after a
    synchronize."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        with profile(activities=activities) as prof:
            yield
        path = os.path.join(tmp, "segment.json")
        prof.export_chrome_trace(path)
        seg = parse_chrome(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    outer = [(a, b) for n, a, b in seg.spans if n == "segment"]
    if not outer:
        raise RuntimeError("the profiled segment has no pb.segment span")
    seg.start, seg.end = outer[0]
    seg.spans = [s for s in seg.spans if s[0] != "segment"]
    result.append(seg)


def breakdown(seg: Segment, claimed: Sequence[str], top: int = 10) -> Dict:
    """{"device_ops": [[group, seconds], ...], "idle_gaps": [[span,
    seconds], ...]}; a port kernel that no metric's list claims is named
    among the device operations."""
    ops = sorted(([g, s] for g, s in seg.by_group().items()),
                 key=lambda r: -r[1])
    unclaimed: Dict[str, float] = {}
    for n, a, b in seg.device:
        if matches(n, PORT_KERNELS) and not matches(n, claimed):
            unclaimed[n] = unclaimed.get(n, 0.0) + (b - a)
    extra = [[f"unclaimed port kernel: {n[:120]}", s]
             for n, s in sorted(unclaimed.items(), key=lambda r: -r[1])]
    ops = (extra + ops)[:top]
    return {"device_ops": ops, "idle_gaps": seg.idle_gaps(top)}
