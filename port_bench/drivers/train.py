"""Training traffic: a closed loop of train steps.

The program's step (`train.step.make_train_step`) over a pool of
distinct corpus-like batches from the frozen generator; each step copies
its batch to the card as the training loop does (`train.loop.
device_batch`).  Set-up builds one step object with its model and
optimizer state, drives it from the seed through its first steps (the
window's own call and feed, on distinct rows), records what the check
compares, warms up, and hands the same object to the window.

Traffic parameters: batch, pool (distinct batches), checked_steps (the
first steps the reference follows), warm_steps (more steps before the
window), traced_steps (the profiled segment).

The check: the reference follows the checked steps from the same
weights, batches and generator state.  Numbers compared:
- loss_gap: the widest |loss - reference| / |reference| over the steps;
- loss1_gap: the same for the first step alone (later steps carry the
  first update's round-off, which Adam scales to a full step for every
  element whose gradient is near zero);
- grad_gap: the first gradient as the optimizer got it (Adam's first
  moment after one step / (1 - b1)), by the worst parameter: |norm -
  reference norm| / max(reference norm, the median parameter's);
- change_gap: the same for each parameter's change after the checked
  steps, over the parameters whose reference gradient is at least 1e-3
  of the median parameter's (smaller ones move by round-off alone);
- ema_gap: the same for the EMA's change, where the configuration keeps
  an EMA;
- vertex1_gap, exist1_gap, edge1_gap: the widest gaps of the first
  step's forward outputs (read by a forward hook on the model during that
  step alone), before any matching: vertices, existence probabilities
  and edge probabilities (the sigmoid of every pair's logit);
- free1_gap: |terms - reference| / |reference| of the first step's loss
  terms that no matching decides (existence and edge BCE against the
  given labels), where the configuration does not label them through the
  matching;
- grad_gap_median, change_gap_median: the median parameter's gap.
A tie in the Hungarian matching (L1 costs of several pairings equal, or
equal to rounding) lets rounding pick another pairing, which moves the
matched terms and the heads' gradients by much more than rounding does:
the numbers a cell compares, and their limits, are in its limits file
(`port_bench/limits/<workload>.json`); the others are printed only.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import corpus, stats
from port_bench.drivers import common

MOVING_SHARE = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
               ) -> Dict[str, float]:
    """{name: float64 norm} of every tensor, computed in one transfer."""
    names = sorted(tensors)
    norms = torch.stack([tensors[k].double().norm() for k in names])
    return dict(zip(names, (norms * scale).tolist()))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> np.ndarray:
    """|norm - reference norm| / max(reference norm, the median
    parameter's reference norm), parameter by parameter."""
    names = [k for k in ref if keep is None or k in keep]
    median = float(np.median([ref[k] for k in names]))
    return np.array([abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
                     for k in names])


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared, from the program's readings and the
    reference's (both as `readings` gives them)."""
    g = ref["first_grad"]
    median = float(np.median(list(g.values())))
    moving = {k for k, x in g.items() if x >= MOVING_SHARE * median}
    grad = leaf_gaps(prog["first_grad"], g)
    change = leaf_gaps(prog["change"], ref["change"], moving)
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], ref["losses"])),
           "loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
           / abs(ref["losses"][0]),
           "grad_gap": float(grad.max()),
           "grad_gap_median": float(np.median(grad)),
           "change_gap": float(change.max()),
           "change_gap_median": float(np.median(change))}
    for key, name in (("vertices", "vertex1_gap"),
                      ("existence_probabilities", "exist1_gap"),
                      ("edge_logits", "edge1_gap")):
        a, b = prog["forward1"][key], ref["forward1"][key]
        n = min(len(a), len(b))          # a fault may leave rows out
        a, b = a[:n], b[:n]
        if key == "edge_logits":
            a, b = torch.sigmoid(a), torch.sigmoid(b)
        out[name] = float((a.double() - b.double()).abs().max())
    if ref.get("free1") is not None:
        out["free1_gap"] = abs(prog["free1"] - ref["free1"]) / abs(
            ref["free1"])
    if ref.get("ema_change") is not None:
        out["ema_gap"] = float(leaf_gaps(prog["ema_change"],
                                         ref["ema_change"], moving).max())
    return out


def matching_free(t: Dict, existence: float, edge: float):
    """The first step's loss terms that no matching decides (existence and
    edge BCE against the given labels), or None where the configuration
    labels them through the matching."""
    if t["matched_existence_labels"] or t["matched_edge_labels"]:
        return None
    return t["existence_weight"] * existence + t["edge_weight"] * edge


def readings(follow_out: Dict, t: Dict) -> Dict:
    """The reference's `follow` output reduced to what `compare` reads."""
    ema = follow_out["ema_change"]
    first = follow_out["terms"][0]
    return {"losses": follow_out["losses"],
            "free1": matching_free(t, first["existence"], first["edge"]),
            "forward1": follow_out["forward1"],
            "first_grad": leaf_norms(follow_out["first_grad"]),
            "change": leaf_norms(follow_out["change"]),
            "ema_change": leaf_norms(ema) if ema is not None else None}


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.device, self.spans = cell, device, spans
        self.t = cell.traffic
        self.seed_w, self.seed_data, self.seed_gen, _ = common.seeds(seed)
        self.i = 0
        self.failed = 0

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        from wireframe_tpu_torch.train.loop import device_batch
        from wireframe_tpu_torch.train.state import create_train_state
        from wireframe_tpu_torch.train.step import make_train_step

        cfg = common.program_config(self.cell.config)
        self.cfg = cfg
        self.device_batch = device_batch
        b, n = int(self.t["batch"]), cfg.data.num_points
        rng = np.random.default_rng(self.seed_data)
        self.pool = [corpus.train_batch(rng, b, n, cfg.data.max_vertices,
                                        cfg.data.z_sort_points)
                     for _ in range(int(self.t["pool"]))]
        model, self.weights = common.build_model(cfg, self.seed_w,
                                                 self.device)
        self.state = create_train_state(cfg, model)
        self.step = make_train_step(cfg)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed_gen)
        self.gen_state0 = self.gen.get_state()
        self.prog = self._first_steps(int(self.t["checked_steps"]))
        for _ in range(int(self.t["warm_steps"])):
            self._one()
        self._sync()

    def _one(self):
        with self.spans.span("h2d"):
            batch = self.device_batch(self.pool[self.i % len(self.pool)],
                                      self.device)
        with self.spans.span("step"):
            self.state, m = self.step(self.state, batch, self.gen)
        self.i += 1
        return m

    def _first_steps(self, steps: int) -> Dict:
        """Drive the step object through its first steps and read what
        the check compares (in set-up: it syncs)."""
        b1 = self.cfg.train.adam_b1
        losses = []
        seen = []
        hook = self.state.model.register_forward_hook(
            lambda mod, args, out: seen.append(
                {k: out[k].detach().float().clone() for k in
                 ("vertices", "existence_probabilities", "edge_logits")}))
        for s in range(steps):
            m = self._one()
            losses.append(float(m["total_loss"]))
            if s == 0:
                hook.remove()
                forward1 = seen[0]
                first = leaf_norms(self.state.mu, 1.0 / (1.0 - b1))
                free1 = matching_free(self.cell.config["train"],
                                      float(m["existence_loss"]),
                                      float(m["edge_loss"]))
        params = self.state.params
        out = {"losses": losses, "free1": free1, "forward1": forward1,
               "first_grad": first,
               "change": leaf_norms({k: params[k].detach()
                                     - self.weights[k] for k in params}),
               "ema_change": None}
        if self.state.ema_params is not None:
            out["ema_change"] = leaf_norms(
                {k: self.state.ema_params[k] - self.weights[k]
                 for k in params})
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- window --------------------------------------------------------
    def window(self, seconds: float):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while True:
            m = self._one()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        if not math.isfinite(float(m["total_loss"])):
            self.failed += 1
        self.window_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        b = int(self.t["batch"])
        self.stats = {"attempted": steps, "failed": self.failed,
                      "wall": t1 - t0, "steps": steps, "batch": b,
                      "clouds": steps * b, "t0": t0, "t1": t1,
                      "peak_bytes": self.window_peak,
                      "points": self.cfg.data.num_points,
                      "chain_backward": self.cfg.model.chain_backward}
        return {"train_clouds_per_s": steps * b / (t1 - t0)}, self.stats

    def segment(self) -> None:
        k = int(self.t["traced_steps"])
        with self.spans.span("segment"):
            for _ in range(k):
                self._one()
            self._sync()
        self.stats["segment_units"] = k

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(max(self.setup_peak, self.window_peak,
                       torch.cuda.max_memory_allocated(self.device)))

    def notes(self) -> List[str]:
        s = self.stats
        calls = self.spans.durations("step", s["t0"], s["t1"])
        copies = self.spans.durations("h2d", s["t0"], s["t1"])
        return [f"{s['steps']} steps of {s['batch']} clouds in "
                f"{s['wall']:.6f} s; losses of the checked steps "
                f"{self.prog['losses']}",
                "host ms in the step call: median "
                f"{1e3 * stats.percentile(calls, 50):.3f}, p90 "
                f"{1e3 * stats.percentile(calls, 90):.3f}, max "
                f"{1e3 * max(calls):.3f}; in the copy: median "
                f"{1e3 * stats.percentile(copies, 50):.3f}",
                "steps begun in each second of the window: "
                f"{self._per_second('step')}"]

    def _per_second(self, name: str) -> List[int]:
        s = self.stats
        out = [0] * int(math.ceil(s["wall"]))
        for n, a, _ in self.spans.records:
            if n == name and s["t0"] <= a < s["t1"]:
                out[min(int(a - s["t0"]), len(out) - 1)] += 1
        return out

    def free(self) -> None:
        del self.state, self.step
        common.free_cuda()

    # -- check ---------------------------------------------------------
    def reference_readings(self, lower: str = "", rows=None) -> Dict:
        """The reference's readings; `rows`: only these rows of each
        batch (the fault of a step that leaves part of the batch out)."""
        from port_bench.reference.train import follow

        k = int(self.t["checked_steps"])
        batches = [{key: torch.as_tensor(v[rows] if rows is not None
                                         else v).to(self.device)
                    for key, v in self.pool[s % len(self.pool)].items()}
                   for s in range(k)]
        out = follow(self.cell.config, self.weights, batches,
                     self.gen_state0,
                     common.precision(self.cell.config, lower))
        return readings(out, self.cell.config["train"])

    def _full_reference(self) -> Dict:
        if getattr(self, "_ref", None) is None:
            self._ref = self.reference_readings()
        return self._ref

    def program_numbers(self) -> Dict[str, float]:
        return compare(self.prog, self._full_reference())

    def control_numbers(self) -> Dict[str, float]:
        """The reference in the control precision, in the program's
        place."""
        lower = common.control_precision(self.cell.config)
        return compare(self.reference_readings(lower),
                       self._full_reference())

    def fault_numbers(self) -> Dict[str, float]:
        """A step that leaves half of the batch out and takes the mean over
        the rest (the reference on the first half of each batch), in the
        program's place."""
        half = slice(0, int(self.t["batch"]) // 2)
        return compare(self.reference_readings(rows=half),
                       self._full_reference())

    def check(self):
        return common.checks(self.program_numbers(), self.cell.limits)
