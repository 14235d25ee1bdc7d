"""Bulk inference of dense clouds of many sizes through the PTv2 backbone.

The PTv3 cell's traffic and set-up (`infer_ptv3.Driver`: page-locked host
batches of `infer_ptv3.ptv3_batch`'s clouds, results copied back, up to
`in_flight` calls outstanding; weights as `infer_ptv3.ptv3_weights` draws
them, BatchNorm scales and running variances at 1 + 0.05 n), so the two
backbones are compared on one input.  The program's config is read
before any cloud is made, so a program without `model.encoder: ptv2`
fails at once.

The reference (`reference/ptv2.py`) runs one cloud at a time on each
checked call's input.  `fault_numbers`: the reference with the positional
bias of encoder stage 0's first block left out, against the reference,
the planted fault the limits are set against beside the fp8 control.

After the window (outside its time) this Driver reads the backbone's
device counters and counts, from the pool's own clouds, the forward's
operations a cloud (`counts_ptv2`), for the per-layer metrics.  A call
over a level's capacity fails the run: the counters are read for it
before the window (set-up and warm-up calls), after it and after the
traced segment.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from port_bench import counts_ptv2
from port_bench.drivers import common, infer, infer_ptv3
from port_bench.reference import ptv2 as ref_ptv2

FAULT = ("enc0.0",)


class Driver(infer_ptv3.Driver):
    def window(self, seconds: float):
        from wireframe_tpu_torch.models.ptv3 import capacity_rows

        backbone = self.model.encoder.backbone
        self._raise_on_overflow()
        backbone.reset_counters()
        values, stats = infer.Driver.window(self, seconds)
        self._raise_on_overflow()
        stats["ptv2_counters"] = backbone.counters()
        stats["ptv2_capacity_rows"] = [
            capacity_rows(c, stats["batch"] * stats["points"])
            for c in self.cfg.model.ptv2_capacity]
        stats["ptv2_level_k"] = list(backbone.level_k)
        stats["ptv2_flops_per_cloud"] = self._flops_per_cloud()
        return values, stats

    def _flops_per_cloud(self) -> float:
        m = self.cell.model
        total, clouds = 0.0, 0
        for x in self.pool:
            xt = torch.from_numpy(x).to(self.device)
            for rec in ref_ptv2.counts_of(m, xt):
                total += counts_ptv2.forward_flops(m, rec, x.shape[1])
                clouds += 1
        return total / clouds

    def notes(self) -> List[str]:
        s = self.stats
        c = s["ptv2_counters"]
        calls = max(c["calls"], 1)
        rows = ", ".join(
            f"level {i}: {c[f'rows.level{i}'] / calls:.1f} a call, most "
            f"{c[f'rows_max.level{i}']} of {cap}, kNN slots "
            f"{c[f'knn_slots.level{i}'] / calls:.1f} a call at k "
            f"{s['ptv2_level_k'][i]}"
            for i, cap in enumerate(s["ptv2_capacity_rows"]))
        return infer.Driver.notes(self) + [
            f"ptv2 rows ({rows}); grid sampling dropped "
            f"{c['grid_dropped']} of {c['input_rows']} input rows; GVA "
            f"neighbour slots real {c['gva_real_slots']}, computed "
            f"{c['gva_slots']}; overflowing calls {c['overflow_calls']}; "
            f"forward {s['ptv2_flops_per_cloud']!r} operations a cloud"]

    def _reference(self, index: int, lower: str = "", skip_peb=()):
        key = (index, lower, tuple(skip_peb))
        if key not in self._refs:
            x = torch.from_numpy(self.pool[index % len(self.pool)]).to(
                self.device)
            prec = common.precision(self.cell.config, lower)
            with torch.no_grad(), prec.matmul_mode():
                self._refs[key] = ref_ptv2.forward(
                    prec, self.weights, self.cell.model, x,
                    skip_peb=skip_peb)
        return self._refs[key]

    def fault_numbers(self) -> Dict[str, float]:
        b = int(self.t["batch"])
        parts = []
        for i, _ in self.kept:
            bad = self._reference(i, skip_peb=FAULT)
            as_prog = {"vertices": bad["vertices"].float().cpu().numpy(),
                       "existence_probabilities":
                       bad["existence_probabilities"].float().cpu().numpy(),
                       "edge_probs": bad["edge_probs"].float().cpu().numpy(),
                       "actual_vertex_counts": (bad["existence_probabilities"]
                                                > 0.5).sum(-1).cpu().numpy()}
            parts.append(common.forward_gaps(as_prog, self._reference(i), b))
        return common.merge_max(parts)
