"""Profiling / tracing helpers.

Port of `wireframe_tpu/utils/profiling.py`: a context manager around
`torch.profiler` that writes a Chrome trace (chrome://tracing, Perfetto),
a step timer that reports the steady-state step time and the derived
clouds/sec, and `device_rows`, the device time by kernel of a profile.

`span(name)` marks a layer of the program (augmentation, forward, loss,
matcher, backward, optimizer; encoder, vertex head, edge head) while a
`torch.profiler` records: a `record_function` range "wf.<name>" in the
trace, beside the kernels it launches.  `tools/trace_ops.py` sums the
device time of the launches inside each.

The bench and the tools time through the two protocols here:
`chained_seconds` (every call chained on one device scalar, read back
once, so the host never waits inside the window) and `round_trips`
(every call reads its own result back: the latency a client sees).
`card_samples` records the card's SM clock and power while a window
runs, so that a reading can be told apart from a clock change.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_T0 = time.perf_counter()


def log(tag: str, msg: str) -> None:
    """A progress line on stderr, stamped with the seconds since import."""
    print(f"[{tag} +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def staged_clouds(rng: np.random.Generator, batch: int, points: int,
                  dim: int, count: int, device) -> List[torch.Tensor]:
    """`count` distinct (batch, points, dim) f32 clouds drawn from `rng`
    and moved to `device` before any timing, so that no two consecutive
    calls read the same input."""
    return [torch.from_numpy(rng.normal(size=(batch, points, dim))
                             .astype(np.float32)).to(device)
            for _ in range(count)]


def chained_seconds(call: Callable[[torch.Tensor, int], torch.Tensor],
                    iters: int, device, warmup: int = 0,
                    profile_dir: Optional[str] = None) -> float:
    """Seconds per call of call(s, i) -> a 0-d device tensor that depends
    on s.  `warmup` untimed calls, then `iters` timed ones, each chained on
    the previous scalar and read back once at the end (the read-back waits
    for all the work queued on the stream).  With profile_dir the timed
    window runs under `trace(profile_dir)`."""
    def run(n):
        s = torch.zeros((), device=device)
        for i in range(n):
            s = call(s, i)
        return float(s)

    if warmup:
        run(warmup)
    with trace(profile_dir):
        t0 = time.perf_counter()
        run(iters)
        elapsed = time.perf_counter() - t0
    return elapsed / iters


def round_trips(call: Callable[[int], float], iters: int,
                items_per_step: int = 1) -> dict:
    """`StepTimer.summary` of `iters` calls of call(i), each of which ends
    in its own host read-back, after 2 untimed ones."""
    for i in range(2):
        call(i)
    timer = StepTimer(warmup=0)
    for i in range(iters):
        timer.tick()
        call(i)
    timer.tick()
    return timer.summary(items_per_step=items_per_step)


CARD_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")


@contextlib.contextmanager
def card_samples(device, period_ms: int = 100) -> Iterator[Dict]:
    """Sample the card's SM and memory clocks (MHz), power draw (W) and
    temperature (C) every period_ms while the block runs (`nvidia-smi
    -lms`, in a process of its own that is stopped at exit).  Yields a
    dict that is filled at exit with {field: [min, mean, max]} and
    "samples"; it stays empty on the CPU or where nvidia-smi fails."""
    found: Dict = {}
    dev = torch.device(device)
    if dev.type != "cuda":
        yield found
        return
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", str(dev.index or 0),
         f"--query-gpu={','.join(CARD_FIELDS)}",
         "--format=csv,noheader,nounits", "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield found
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    rows = [r for r in rows if len(r) == len(CARD_FIELDS)]
    if rows:
        cols = np.asarray(rows)
        found["samples"] = len(rows)
        for j, name in enumerate(CARD_FIELDS):
            found[name] = [float(cols[:, j].min()), float(cols[:, j].mean()),
                           float(cols[:, j].max())]


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[object]]:
    """torch.profiler over the block when log_dir is set (CPU activity,
    and CUDA activity when a card is present); no-op otherwise.

    Yields the profiler (None when off).  On exit the trace is written to
    `<log_dir>/<pid>.<ns>.pt.trace.json`.  Synchronize inside the block
    if the traced work must be complete: the profiler stops at exit.
    """
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


SPAN_PREFIX = "wf."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A "wf.<name>" `record_function` range while a `torch.profiler`
    records; otherwise the one shared null context (no allocation, no call
    into torch beyond the check).  It changes nothing the block computes."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def device_rows(prof) -> List[Tuple[float, int, str]]:
    """(ms, count, name) of every kernel, copy and memset the profile saw
    on the card.  Only the device-side events: an operator's row also
    carries the device time of the kernels it launched, so summing both
    would count them twice.  A `record_function` range (a `span`) has a
    device-side copy too, from its first kernel to its last; it is a
    user annotation, not work, and is left out."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if (us > 0 and e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith(SPAN_PREFIX)):
            rows.append((us / 1e3, e.count, e.key))
    return rows


class StepTimer:
    """Wall-clock step statistics with warmup discard.

    Only trust intervals that end in a host read-back or a synchronize:
    PyTorch returns before the card has finished the work it queued.
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def steady_times(self) -> List[float]:
        return self._times[self.warmup:]

    @staticmethod
    def percentile(sorted_ts: List[float], q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) of a pre-sorted list."""
        if not sorted_ts:
            return float("nan")
        idx = min(len(sorted_ts) - 1,
                  max(0, int(round(q / 100.0 * (len(sorted_ts) - 1)))))
        return sorted_ts[idx]

    def summary(self, items_per_step: int = 1) -> dict:
        ts = self.steady_times or self._times
        if not ts:
            return {}
        ts_sorted = sorted(ts)
        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "p50_s": self.percentile(ts_sorted, 50),
            "p90_s": self.percentile(ts_sorted, 90),
            "p99_s": self.percentile(ts_sorted, 99),
            "items_per_sec": items_per_step * len(ts) / sum(ts),
        }
