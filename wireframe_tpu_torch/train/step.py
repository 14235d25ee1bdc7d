"""The train step.

Port of `wireframe_tpu/train/step.py:make_train_step`: (optional) batched
device augmentation -> forward in train mode (encoder chain K2) ->
Hungarian-matched loss (assignment by K4) -> backward (chain gradient by
K3) -> global-norm clip, coupled weight decay, Adam, learning rate -> EMA.
Nothing in the step reads a value back to the host: the metrics are
0-d device tensors, and the loop reads them at its log points only.

`make_forward_fn` is the inference forward that serving, the bench and
the measuring tools call.

Also the reference's monitoring metrics (train.py:148-151): the
index-aligned vertex RMSE of sample 0's GT-count prefix, the batched
Hungarian RMSE through the loss's matching, and the train-batch edge
precision / recall / F1 against the labels the edge BCE used.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from wireframe_tpu_torch.data.augment import augment_batch
from wireframe_tpu_torch.losses.wireframe_loss import (
    WireframeLossConfig,
    wireframe_loss,
)
from wireframe_tpu_torch.train.state import Optimizer, TrainState, global_norm

BATCH_KEYS = ("point_clouds", "target_vertices", "vertex_existence",
              "vertex_counts", "edge_labels")


def _monitor_metrics(pred_vertices, batch, matched_cols
                     ) -> Dict[str, torch.Tensor]:
    tgt = batch["target_vertices"]
    counts = batch["vertex_counts"].to(torch.int32)
    v = tgt.shape[1]
    slot = torch.arange(v, dtype=torch.int32, device=tgt.device)

    # Index-aligned RMSE over sample 0's prefix (reference monitor).
    m0 = (slot < counts[0]).to(torch.float32)[:, None]
    diff0 = (pred_vertices[0] - tgt[0]) * m0
    n0 = torch.clamp_min(torch.sum(m0) * 3.0, 1.0)
    rmse0 = torch.sqrt(torch.sum(diff0 * diff0) / n0)

    # Hungarian RMSE over the whole batch using the loss's matching.
    matched = matched_cols < counts[:, None]
    safe = torch.where(matched, matched_cols,
                       torch.zeros_like(matched_cols)).long()
    tgt_m = torch.take_along_dim(tgt, safe[..., None], dim=1)
    d = (pred_vertices - tgt_m) * matched[..., None].to(torch.float32)
    n = torch.clamp_min(torch.sum(matched.to(torch.float32)) * 3.0, 1.0)
    h_rmse = torch.sqrt(torch.sum(d * d) / n)
    return {"vertex_rmse": rmse0, "hungarian_rmse": h_rmse}


def _edge_prf(edge_probs, losses, thresh: float = 0.5
              ) -> Dict[str, torch.Tensor]:
    labels = losses["edge_labels_eff"]
    mask = losses["pair_mask_eff"]
    pred_pos = (edge_probs > thresh).to(torch.float32) * mask
    pos = labels * mask
    tp = torch.sum(pred_pos * pos)
    p = tp / torch.clamp_min(torch.sum(pred_pos), 1.0)
    r = tp / torch.clamp_min(torch.sum(pos), 1.0)
    f1 = 2.0 * p * r / torch.clamp_min(p + r, 1e-9)
    return {"train_edge_precision": p, "train_edge_recall": r,
            "train_edge_f1": f1}


def loss_config(cfg) -> WireframeLossConfig:
    """The loss settings of `cfg.train`."""
    t = cfg.train
    return WireframeLossConfig(
        vertex_weight=t.vertex_weight, edge_weight=t.edge_weight,
        existence_weight=t.existence_weight, matcher=t.matcher,
        matched_edge_labels=t.matched_edge_labels,
        matched_existence_labels=t.matched_existence_labels)


def make_train_step(cfg, steps_per_epoch: int = 1) -> Callable:
    """Returns train_step(state, batch, generator) -> (state, metrics).

    batch: the `BATCH_KEYS` tensors on the model's device; generator: a
    torch.Generator on that device (augmentation and dropout draws).  The
    state is updated in place and returned.
    """
    loss_cfg = loss_config(cfg)
    do_augment = cfg.train.device_augment and cfg.data.augment
    optimizer = Optimizer(cfg, steps_per_epoch)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        point_clouds = batch["point_clouds"]
        target_vertices = batch["target_vertices"]
        if do_augment:
            point_clouds, target_vertices = augment_batch(
                generator, point_clouds, target_vertices,
                rot_degrees=cfg.train.aug_rot_degrees,
                jitter_std=cfg.train.aug_jitter_std,
                scale_range=cfg.train.aug_scale_range)
        work = dict(batch, point_clouds=point_clouds,
                    target_vertices=target_vertices)
        preds = state.model(work["point_clouds"], work["vertex_counts"],
                            train=True, generator=generator)
        targets = {"vertices": work["target_vertices"],
                   "vertex_existence": work["vertex_existence"],
                   "edge_labels": work["edge_labels"],
                   "vertex_counts": work["vertex_counts"]}
        losses = wireframe_loss(preds, targets, loss_cfg)
        params = state.params
        names = list(params)
        grads = torch.autograd.grad(losses["total_loss"],
                                    [params[k] for k in names],
                                    allow_unused=True)
        # A parameter the loss does not reach has a zero gradient, as
        # jax.grad gives it.
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(names, grads)}
        g_norm = global_norm(grads.values())
        optimizer.apply(state, grads, g_norm)

        metrics = {
            "total_loss": losses["total_loss"].detach(),
            "vertex_loss": losses["vertex_loss"].detach(),
            "existence_loss": losses["existence_loss"].detach(),
            "edge_loss": losses["edge_loss"].detach(),
            "grad_norm": g_norm,
        }
        with torch.no_grad():
            metrics.update(_monitor_metrics(preds["vertices"].detach(), work,
                                            losses["matched_cols"]))
            metrics.update(_edge_prf(preds["edge_probs"].detach(), losses))
        return state, metrics

    train_step.optimizer = optimizer
    return train_step


def make_forward_fn(cfg) -> Callable:
    """The inference forward: forward(model, point_clouds, counts=None)
    -> predictions, as device tensors.

    Port of `wireframe_tpu/train/step.py:make_forward_fn` with its default
    train=False.  The port's params live in the model (`TrainState.model`,
    `eval.evaluator.build_model`), so the model takes the place of the
    flax params.  It runs under `torch.inference_mode`, where no autograd
    record is kept.
    """
    def forward(model, point_clouds: torch.Tensor,
                target_vertex_counts: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return model(point_clouds, target_vertex_counts, train=False)

    return forward
