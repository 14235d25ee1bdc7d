"""Bulk inference of dense clouds of many sizes through the PTv3 backbone.

`infer.Driver`'s traffic (page-locked host batches, results copied back,
up to `in_flight` calls outstanding) with other batches: each of the
`batch` clouds is made by `corpus.make_building` at a point count from
`corpus.log_uniform_sizes(batch, min_share * N, N)` (N =
`data.num_points`, the port's largest bucket), the same set of sizes for
every seed in an order drawn from it, normalised, z-sorted and padded with
zero rows to N.  So seeds change the clouds and their order, not the
amount of work.

Weights are `weights.make_weights` on the program's names, with each
BatchNorm's scale and running variance drawn as a LayerNorm scale is
(1 + 0.05 n), so every variance is positive.

The reference (`reference/ptv3.py`) runs one cloud at a time on each
checked call's input.  `fault_numbers`: the reference with the xCPE branch
of encoder stage 0's first block left out, against the reference, the
planted fault the limits are set against beside the fp8 control.

After the window (outside its time) this Driver reads the backbone's
device counters and counts, from the pool's own grid coordinates, the
forward's operations a cloud (`counts_ptv3`), for the per-layer metrics.
A call over a stage's capacity fails the run: the counters are read for
it before the window (set-up and warm-up calls), after it and after the
traced segment.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench import corpus, counts_ptv3
from port_bench.drivers import common, infer
from port_bench.reference import ptv3 as ref_ptv3
from port_bench.weights import make_weights

FAULT = ("enc0.0",)


def ptv3_batch(rng: np.random.Generator, batch: int, num_points: int,
               min_share: float) -> np.ndarray:
    """(batch, num_points, 8) float32 clouds of log-uniform sizes."""
    sizes = corpus.log_uniform_sizes(batch, int(min_share * num_points),
                                     num_points)
    out = np.zeros((batch, num_points, 8), np.float32)
    for row, i in enumerate(rng.permutation(batch)):
        raw, _, _ = corpus.make_building(rng, n_points=sizes[i])
        pc, _, _, _ = corpus.normalize(corpus.select_features(raw))
        out[row, :sizes[i]] = corpus.z_sort_rows(pc)
    return out


def _is_batch_norm(name: str) -> bool:
    module = name.rsplit(".", 2)[-2]
    return module.startswith("bn") or module.endswith("_bn")


def ptv3_weights(shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """`make_weights`, then BatchNorm scales and running variances at
    1 + 0.05 n (make_weights drew them as vectors, 0.02 n)."""
    w = make_weights(shapes, seed, device)
    for name in w:
        leaf = name.rsplit(".", 1)[-1]
        if _is_batch_norm(name) and leaf in ("weight", "running_var"):
            w[name] = 1.0 + w[name] * (0.05 / 0.02)
    return w


def build_model(cfg, seed: int, device):
    from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  PointCloudToWireframe(cfg.model).state_dict().items()}
    weights = ptv3_weights(shapes, seed, device)
    with torch.device(device):
        model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(weights, strict=True)
    return model, weights


class Driver(infer.Driver):
    def __init__(self, *args):
        super().__init__(*args)
        self._refs: Dict = {}      # the reference's outputs, by call

    def setup(self) -> None:
        from wireframe_tpu_torch.train.step import make_forward_fn

        cfg = common.program_config(self.cell.config)
        self.cfg = cfg
        on_card = self.device.type == "cuda"
        rng = np.random.default_rng(self.seed_data)
        self.pool = [ptv3_batch(rng, int(self.t["batch"]),
                                cfg.data.num_points,
                                float(self.t["min_share"]))
                     for _ in range(int(self.t["pool"]))]
        self.pool_host = [torch.from_numpy(x) for x in self.pool]
        if on_card:
            self.pool_host = [x.pin_memory() for x in self.pool_host]
        self.model, self.weights = build_model(cfg, self.seed_w,
                                               self.device)
        self.model.eval()
        self.forward = make_forward_fn(cfg)
        self.sampler = np.random.default_rng(self.seed_sample)
        out = self.forward(self.model, self.pool_host[0].to(self.device))
        self.slots = [{k: torch.empty(out[k].shape, dtype=out[k].dtype,
                                      pin_memory=on_card)
                       for k in common.FORWARD_KEYS}
                      for _ in range(int(self.t["in_flight"]))]
        self.free_slots = list(range(len(self.slots)))
        for _ in range(int(self.t["warm_calls"])):
            self._send()
        self._drain(None)

    def _raise_on_overflow(self) -> None:
        from wireframe_tpu_torch.models.ptv3 import (
            OVERFLOW,
            raise_on_overflow,
        )

        backbone = self.model.encoder.backbone
        raise_on_overflow({OVERFLOW: backbone.overflowed()})

    def window(self, seconds: float):
        from wireframe_tpu_torch.models.ptv3 import capacity_rows

        backbone = self.model.encoder.backbone
        self._raise_on_overflow()
        backbone.reset_counters()
        values, stats = super().window(seconds)
        self._raise_on_overflow()
        stats["ptv3_counters"] = backbone.counters()
        stats["ptv3_capacity_rows"] = [
            capacity_rows(c, stats["batch"] * stats["points"])
            for c in self.cfg.model.ptv3_capacity]
        stats["flops_per_cloud"] = self._flops_per_cloud()
        return values, stats

    def segment(self) -> None:
        super().segment()
        self._raise_on_overflow()

    def _flops_per_cloud(self) -> float:
        m = self.cell.model
        total, clouds = 0.0, 0
        for x in self.pool:
            xt = torch.from_numpy(x).to(self.device)
            for rec in ref_ptv3.counts_of(m, xt):
                total += counts_ptv3.forward_flops(m, rec, x.shape[1])
                clouds += 1
        return total / clouds

    def notes(self) -> List[str]:
        s = self.stats
        c = s["ptv3_counters"]
        rows = ", ".join(
            f"stage {i}: {c[f'rows.stage{i}'] / max(c['calls'], 1):.1f} "
            f"a call, most {c[f'rows_max.stage{i}']} of {cap}"
            for i, cap in enumerate(s["ptv3_capacity_rows"]))
        return super().notes() + [
            f"ptv3 rows ({rows}); grid sampling dropped "
            f"{c['grid_dropped']} of {c['input_rows']} input rows; "
            f"attention rows real {c['attn_real_rows']}, padding "
            f"{c['attn_padded_rows']}; overflowing calls "
            f"{c['overflow_calls']}; forward {s['flops_per_cloud']!r} "
            f"operations a cloud"]

    def _reference(self, index: int, lower: str = "", skip_cpe=()):
        key = (index, lower, tuple(skip_cpe))
        if key not in self._refs:
            x = torch.from_numpy(self.pool[index % len(self.pool)]).to(
                self.device)
            prec = common.precision(self.cell.config, lower)
            with torch.no_grad(), prec.matmul_mode():
                self._refs[key] = ref_ptv3.forward(
                    prec, self.weights, self.cell.model, x,
                    skip_cpe=skip_cpe)
        return self._refs[key]

    def fault_numbers(self) -> Dict[str, float]:
        b = int(self.t["batch"])
        parts = []
        for i, _ in self.kept:
            bad = self._reference(i, skip_cpe=FAULT)
            as_prog = {"vertices": bad["vertices"].float().cpu().numpy(),
                       "existence_probabilities":
                       bad["existence_probabilities"].float().cpu().numpy(),
                       "edge_probs": bad["edge_probs"].float().cpu().numpy(),
                       "actual_vertex_counts": (bad["existence_probabilities"]
                                                > 0.5).sum(-1).cpu().numpy()}
            parts.append(common.forward_gaps(as_prog, self._reference(i), b))
        return common.merge_max(parts)
