"""Bulk inference traffic: host batches through the forward, results back.

The program's inference forward (`train.step.make_forward_fn`) on a pool
of host batches of corpus-like clouds (normalised, sampled to
`data.num_points`, z-sorted as the configuration asks) in page-locked
host memory.  Each call copies its batch to the card, forwards it and
copies its four arrays (`vertices`, `edge_probs`, `actual_vertex_counts`,
`existence_probabilities`) back into page-locked host buffers of its
own, all without waiting; the host waits for a call's arrays only once
`in_flight` calls are outstanding, as a bulk job that keeps the card fed
does.  So a stall of the host shorter than the queued work leaves the
card busy.  The window ends when its time is up: nothing more is sent,
every call sent is waited for, and the clock is read after that wait;
every call counts, over all of that time.

Traffic parameters: batch, pool, in_flight (calls outstanding at most),
warm_calls, checked_calls (a sample of the window's calls, drawn from
the seed, whose outputs the reference checks), traced_calls.

The check: the reference's forward on each sampled call's input;
numbers compared (`common.forward_gaps`): vertex_gap, exist_gap,
edge_gap, and count_self_gap (the program's reported counts against
its own existence probabilities).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List

import numpy as np
import torch

from port_bench import corpus
from port_bench.drivers import common
from port_bench.reference.model import forward as ref_forward


# The spans in which the host sends a call (`dispatch_ms.infer`).
SEND_SPANS = ("h2d", "forward", "readback")


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.device, self.spans = cell, device, spans
        self.t = cell.traffic
        self.seed_w, self.seed_data, _, self.seed_sample = \
            common.seeds(seed)
        self.i = 0
        self.kept: List = []               # (call index, outputs)
        self.calls = 0
        self.pending: Deque = deque()      # (call index, slot, event)

    def setup(self) -> None:
        from wireframe_tpu_torch.train.step import make_forward_fn

        cfg = common.program_config(self.cell.config)
        self.cfg = cfg
        on_card = self.device.type == "cuda"
        rng = np.random.default_rng(self.seed_data)
        self.pool = [corpus.infer_batch(rng, int(self.t["batch"]),
                                        cfg.data.num_points,
                                        cfg.data.z_sort_points)
                     for _ in range(int(self.t["pool"]))]
        self.pool_host = [torch.from_numpy(x) for x in self.pool]
        if on_card:
            self.pool_host = [x.pin_memory() for x in self.pool_host]
        self.model, self.weights = common.build_model(cfg, self.seed_w,
                                                      self.device)
        self.model.eval()
        self.forward = make_forward_fn(cfg)
        self.sampler = np.random.default_rng(self.seed_sample)
        # One set of page-locked result buffers a call outstanding, shaped
        # by a first call.
        out = self.forward(self.model, self.pool_host[0].to(self.device))
        self.slots = [{k: torch.empty(out[k].shape, dtype=out[k].dtype,
                                      pin_memory=on_card)
                       for k in common.FORWARD_KEYS}
                      for _ in range(int(self.t["in_flight"]))]
        self.free_slots = list(range(len(self.slots)))
        for _ in range(int(self.t["warm_calls"])):
            self._send()
        self._drain(None)

    def _send(self) -> None:
        """Send one call without waiting; first wait for the oldest call
        if `in_flight` are outstanding."""
        if not self.free_slots:
            self._collect(None)
        x = self.pool_host[self.i % len(self.pool_host)]
        slot = self.free_slots.pop()
        buf = self.slots[slot]
        with self.spans.span("h2d"):
            xt = x.to(self.device, non_blocking=True)
        with self.spans.span("forward"):
            out = self.forward(self.model, xt)
        with self.spans.span("readback"):
            for k in common.FORWARD_KEYS:
                buf[k].copy_(out[k], non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        self.pending.append((self.i, slot, event))
        self.i += 1

    def _collect(self, keep) -> None:
        """Wait for the oldest call outstanding; `keep(index, arrays)`
        sees its arrays before its buffers are used again."""
        index, slot, event = self.pending.popleft()
        with self.spans.span("wait"):
            if event is not None:
                event.synchronize()
        if keep is not None:
            keep(index, self.slots[slot])
        self.free_slots.append(slot)

    def _drain(self, keep) -> None:
        while self.pending:
            self._collect(keep)

    def window(self, seconds: float):
        k = int(self.t["checked_calls"])
        seen = [0]

        def keep(index, buf):
            # Reservoir sample of the window's calls, drawn from the seed.
            seen[0] += 1
            if len(self.kept) < k:
                r = len(self.kept)
                self.kept.append(None)
            else:
                r = int(self.sampler.integers(seen[0]))
                if r >= k:
                    return
            self.kept[r] = (index, {n: buf[n].numpy().copy()
                                    for n in common.FORWARD_KEYS})

        t0 = time.perf_counter()
        calls = 0
        while True:
            while len(self.pending) >= len(self.slots):
                self._collect(keep)
            self._send()
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._drain(keep)
        t1 = time.perf_counter()
        b = int(self.t["batch"])
        self.calls = calls
        self.stats = {"attempted": calls * b, "failed": 0, "wall": t1 - t0,
                      "calls": calls, "batch": b, "clouds": calls * b,
                      "points": self.cfg.data.num_points, "t0": t0,
                      "t1": t1}
        return {"infer_clouds_per_s": calls * b / (t1 - t0)}, self.stats

    def segment(self) -> None:
        k = int(self.t["traced_calls"])
        with self.spans.span("segment"):
            for _ in range(k):
                self._send()
            self._drain(None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.stats["segment_units"] = k

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def notes(self) -> List[str]:
        s = self.stats
        send = sum(sum(self.spans.durations(n, s["t0"], s["t1"]))
                   for n in SEND_SPANS)
        wait = sum(self.spans.durations("wait", s["t0"], s["t1"]))
        return [f"{s['calls']} calls of {s['batch']} clouds in "
                f"{s['wall']:.6f} s; checked calls "
                f"{sorted(i for i, _ in self.kept)}",
                f"host in the window: sending {send!r} s "
                f"({1e3 * send / s['calls']!r} ms a call), waiting for "
                f"results {wait!r} s"]

    def free(self) -> None:
        del self.model, self.forward, self.slots, self.pool_host
        common.free_cuda()

    def _reference(self, index: int, lower: str = ""):
        x = torch.from_numpy(self.pool[index % len(self.pool)]).to(
            self.device)
        prec = common.precision(self.cell.config, lower)
        with torch.no_grad(), prec.matmul_mode():
            return ref_forward(prec, self.weights, self.cell.model, x)

    def program_numbers(self) -> Dict[str, float]:
        b = int(self.t["batch"])
        return common.merge_max([common.forward_gaps(res,
                                                     self._reference(i), b)
                                 for i, res in self.kept])

    def control_numbers(self) -> Dict[str, float]:
        b = int(self.t["batch"])
        lower = common.control_precision(self.cell.config)
        parts = []
        for i, _ in self.kept:
            ctl = self._reference(i, lower)
            as_prog = {"vertices": ctl["vertices"].float().cpu().numpy(),
                       "existence_probabilities":
                       ctl["existence_probabilities"].float().cpu().numpy(),
                       "edge_probs": ctl["edge_probs"].float().cpu().numpy(),
                       "actual_vertex_counts": (ctl["existence_probabilities"]
                                                > 0.5).sum(-1).cpu().numpy()}
            parts.append(common.forward_gaps(as_prog, self._reference(i), b))
        return common.merge_max(parts)

    def check(self):
        return common.checks(self.program_numbers(), self.cell.limits)
