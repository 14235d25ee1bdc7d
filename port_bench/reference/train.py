"""Plain reference of the training step: device augmentation, the
Hungarian-matched loss (scipy's solver), gradients by autograd, then
global-norm clipping, coupled weight decay, Adam, the learning-rate
schedule and the EMA of the parameters.

`follow` runs the first steps of a training run from the initial
parameters, the same batches and the same generator state that the
program's step was given, and returns what the benchmark compares: each
step's loss and its terms, the first step's forward outputs (before
any matching), the first gradient as the optimizer gets it
(clipped and decayed), and each parameter's change (and the EMA's) after
the steps.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from port_bench.reference.model import Precision, forward, pair_index


def augment(gen, pc, tv, t: Dict):
    """Flips in x and y (p = 0.5 each), a z-rotation uniform in
    +-aug_rot_degrees, Gaussian jitter of the valid points' XYZ and a
    per-cloud uniform scale, on clouds and target vertices alike; drawn in
    that order from `gen`."""
    b, dev = pc.shape[0], pc.device
    fx = torch.rand(b, generator=gen, device=dev) < 0.5
    fy = torch.rand(b, generator=gen, device=dev) < 0.5
    r = t["aug_rot_degrees"] * math.pi / 180.0
    ang = -r + 2 * r * torch.rand(b, generator=gen, device=dev)
    noise = None
    if t["aug_jitter_std"] > 0:
        noise = torch.randn((b, pc.shape[1], 3), generator=gen, device=dev)
    scale = None
    if t["aug_scale_range"] > 0:
        s = t["aug_scale_range"]
        scale = (1 - s) + 2 * s * torch.rand((b, 1, 1), generator=gen,
                                             device=dev)
    sx = 1.0 - 2.0 * fx.float()
    sy = 1.0 - 2.0 * fy.float()
    c, s_ = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c * sx, -s_ * sy, z], -1),
                       torch.stack([s_ * sx, c * sy, z], -1),
                       torch.stack([z, z, o], -1)], -2)
    if scale is not None:
        rot = rot * scale
    xyz = pc[..., :3] @ rot.transpose(1, 2)
    if noise is not None:
        valid = (pc != 0).any(-1, keepdim=True)
        xyz = xyz + torch.where(valid, t["aug_jitter_std"] * noise,
                                torch.zeros_like(noise))
    return torch.cat([xyz, pc[..., 3:]], -1), tv @ rot.transpose(1, 2)


def match(pred_v, pred_p, tgt_v, counts) -> torch.Tensor:
    """(B, V) target index of each prediction slot, V where unmatched:
    the assignment of each sample's real targets to slots that minimises
    the sum of L1(slot, target) + 2 - 2 p(slot)."""
    b, v, _ = pred_v.shape
    cost = (torch.cdist(tgt_v.double(), pred_v.double(), p=1)
            + (2.0 - 2.0 * pred_p.double())[:, None, :]).cpu().numpy()
    out = np.full((b, v), v, np.int64)
    for s, c in enumerate(counts.tolist()):
        if c:
            rows, cols = linear_sum_assignment(cost[s, :c])
            out[s, cols] = rows
    return torch.from_numpy(out).to(pred_v.device)


def smooth_l1(x):
    a = x.abs()
    return torch.where(a < 1.0, 0.5 * x * x, a - 0.5)


def bce(logits, labels):
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def loss(out, batch, t: Dict) -> Dict[str, torch.Tensor]:
    """total = vertex_weight x matched Smooth-L1 + existence_weight x
    existence BCE + edge_weight x edge BCE, each over the batch's
    normaliser; and the three terms."""
    tgt, counts = batch["target_vertices"], batch["vertex_counts"].long()
    b, v, _ = tgt.shape
    col = match(out["vertices"].detach(), out["existence_probabilities"]
                .detach(), tgt, counts)
    matched = col < counts[:, None]
    safe = torch.where(matched, col, torch.zeros_like(col))
    tm = torch.gather(tgt, 1, safe[..., None].expand(-1, -1, 3))
    n = matched.float().sum()
    v_loss = (smooth_l1(out["vertices"] - tm) * matched[..., None]).sum() \
        / (3.0 * n.clamp_min(1.0))
    ex_labels = (matched.float() if t["matched_existence_labels"]
                 else batch["vertex_existence"])
    e_loss = bce(out["existence_logits"], ex_labels).sum() / (b * v)
    labels = batch["edge_labels"]
    pair_mask = out["pair_mask"].float()
    if t["matched_edge_labels"]:
        i, j = pair_index(v, tgt.device)
        adj = torch.zeros((b, v, v), device=tgt.device)
        adj[:, i, j] = labels
        adj = adj + adj.transpose(1, 2)
        rows = torch.arange(b, device=tgt.device)[:, None]
        pair_mask = (matched[:, i] & matched[:, j]).float()
        labels = adj[rows, safe[:, i], safe[:, j]] * pair_mask
    max_pairs = (counts * (counts - 1) // 2).max().float()
    edge = (bce(out["edge_logits"], labels) * pair_mask).sum() \
        / (b * max_pairs).clamp_min(1.0)
    edge = edge if max_pairs > 0 else edge * 0.0
    return {"total": t["vertex_weight"] * v_loss
            + t["existence_weight"] * e_loss + t["edge_weight"] * edge,
            "vertex": v_loss, "existence": e_loss, "edge": edge}


def learning_rate(t: Dict, count: int, steps_per_epoch: int) -> float:
    """The rate of update number `count` (from 0): constant, or linear
    warmup from 0 then cosine decay to lr x lr_min_ratio."""
    lr = t["learning_rate"]
    if t["lr_schedule"] == "constant":
        return lr
    warm = t["warmup_steps"]
    total = max(t["num_epochs"] * steps_per_epoch, warm + 1)
    if count < warm:
        return lr * count / warm
    c = min(count - warm, total - warm)
    cos = 0.5 * (1 + math.cos(math.pi * c / (total - warm)))
    return lr * ((1 - t["lr_min_ratio"]) * cos + t["lr_min_ratio"])


def follow(cfg: Dict, params: Dict[str, torch.Tensor], batches: List[Dict],
           gen_state: torch.Tensor, prec: Precision,
           steps_per_epoch: int = 1) -> Dict:
    """Run len(batches) steps from `params` (not modified) on `batches`
    (device tensors), drawing from a generator set to `gen_state`."""
    m, t = cfg["model"], cfg["train"]
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    ema = {k: v.detach().clone() for k, v in P.items()}
    b1, b2, eps = t["adam_b1"], t["adam_b2"], t["adam_eps"]
    augmenting = t["device_augment"] and cfg["data"]["augment"]
    losses, terms, first_grad = [], [], None
    with prec.matmul_mode():
        for step, batch in enumerate(batches):
            pc, tv = batch["point_clouds"], batch["target_vertices"]
            if augmenting:
                pc, tv = augment(gen, pc, tv, t)
            out = forward(prec, P, m, pc, batch["vertex_counts"], train=True,
                          gen=gen)
            parts = loss(out, dict(batch, target_vertices=tv), t)
            grads = torch.autograd.grad(parts["total"], list(P.values()),
                                        allow_unused=True)
            losses.append(float(parts["total"].detach()))
            terms.append({k: float(v.detach()) for k, v in parts.items()})
            if step == 0:
                forward1 = {k: out[k].detach().float() for k in
                            ("vertices", "existence_probabilities",
                             "edge_logits")}
            with torch.no_grad():
                g = {k: (gr if gr is not None else torch.zeros_like(P[k]))
                     for k, gr in zip(P, grads)}
                norm = torch.sqrt(sum((x.double() ** 2).sum()
                                      for x in g.values()))
                if norm >= t["grad_clip_norm"]:
                    g = {k: x / norm.float() * t["grad_clip_norm"]
                         for k, x in g.items()}
                g = {k: x + t["weight_decay"] * P[k] for k, x in g.items()}
                if first_grad is None:
                    first_grad = {k: x.clone() for k, x in g.items()}
                n = step + 1
                lr = learning_rate(t, step, steps_per_epoch)
                for k in P:
                    mu[k] = b1 * mu[k] + (1 - b1) * g[k]
                    nu[k] = b2 * nu[k] + (1 - b2) * g[k] * g[k]
                    upd = (mu[k] / (1 - b1 ** n)) / (
                        torch.sqrt(nu[k] / (1 - b2 ** n)) + eps)
                    P[k] -= lr * upd
                    if t["ema_decay"] > 0:
                        ema[k] = t["ema_decay"] * ema[k] \
                            + (1 - t["ema_decay"]) * P[k]
    with torch.no_grad():
        return {"losses": losses, "terms": terms, "forward1": forward1,
                "first_grad": first_grad,
                "change": {k: P[k] - params[k].float() for k in P},
                "ema_change": ({k: ema[k] - params[k].float() for k in P}
                               if t["ema_decay"] > 0 else None)}
