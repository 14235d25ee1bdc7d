"""The train step.

Port of `wireframe_tpu/train/step.py:make_train_step`: (optional) batched
device augmentation -> forward in train mode (encoder chain K2) ->
Hungarian-matched loss (assignment by K4) -> backward (chain gradient by
K3) -> global-norm clip, coupled weight decay, Adam, learning rate -> EMA.
Nothing in the step reads a value back to the host: the metrics are
0-d device tensors, and the loop reads them at its log points only.
Under a `torch.profiler` each stage is a span (`utils.profiling.span`):
augment, forward, loss, backward, optimizer; the monitoring sums are in
none.

`make_forward_fn` is the inference forward that serving, the bench and
the measuring tools call.

Also the reference's monitoring metrics (train.py:148-151): the
index-aligned vertex RMSE of sample 0's GT-count prefix, the batched
Hungarian RMSE through the loss's matching, and the train-batch edge
precision / recall / F1 against the labels the edge BCE used.

More than one device (`layout`, a `parallel.mesh.Layout`): the
counterpart of the JAX step on a (dp, mp) mesh, which computes exactly
the one-device step on the global batch.

- dp: the step takes the rows of this rank's dp index; it augments them
  with the global batch's draws (`data.augment`), divides each loss term
  by the global batch's normaliser (`losses.wireframe_loss`: a SUM of the
  matched-slot counts and a MAX of the pair counts over the dp group),
  so the dp ranks' losses and gradients sum to the global batch's.  The
  metrics are the global batch's, from one SUM of their partial sums
  over the dp group.
- mp: the ranks of an mp group hold the same rows and run the encoder
  on their slices of the point axis (`models.encoder`); everything after
  the encoder runs on every rank of the group alike, on the same
  gathered tokens and with the same dropout draws.  So the point MLP's
  gradients (the encoder's stages and projection) are each rank's
  slice's share and add up over the mp group, while every other
  gradient (the fusion MLP, the decoder, the edge head) is already
  whole on each rank of the group and must count once.  The step
  reduces the two kinds separately, each as one flat buffer: the point
  MLP's SUM over the world, the others' SUM over the dp group only.
  Scaling the second kind by 1 / mp before one world-wide SUM would
  round for an mp that is not a power of two and move those bytes over
  mp ranks for nothing; two reductions are exact for every mp.  With
  mp = 1 the two are one flat SUM over the world.

The clip, decay, Adam and EMA then run unchanged on every rank, which so
holds identical params.  K2, K3 (or K5) and K4 run per rank on its rows
and slice, unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from wireframe_tpu_torch.data.augment import augment_batch
from wireframe_tpu_torch.losses.wireframe_loss import (
    WireframeLossConfig,
    wireframe_loss,
)
from wireframe_tpu_torch.models.ptv3 import OVERFLOW
from wireframe_tpu_torch.parallel.collective_audit import all_reduce
from wireframe_tpu_torch.parallel.mesh import Layout, flat_apply
from wireframe_tpu_torch.train.state import Optimizer, TrainState, global_norm
from wireframe_tpu_torch.utils.profiling import span

BATCH_KEYS = ("point_clouds", "target_vertices", "vertex_existence",
              "vertex_counts", "edge_labels")


# The partial sums the monitoring metrics are ratios of; a rank's sums
# add up over the ranks to the global batch's.
_SUMS = ("total_loss", "vertex_loss", "existence_loss", "edge_loss",
         "sq0", "n0", "hsq", "hn", "tp", "pred_pos", "pos")


def _metric_sums(pred_vertices, batch, losses, edge_probs,
                 first: bool = True, thresh: float = 0.5) -> torch.Tensor:
    """(len(_SUMS),) float32: the loss terms and the partial sums of the
    monitoring metrics.  `first`: these rows hold the batch's sample 0,
    whose prefix the index-aligned RMSE reads."""
    tgt = batch["target_vertices"]
    counts = batch["vertex_counts"].to(torch.int32)
    v = tgt.shape[1]
    slot = torch.arange(v, dtype=torch.int32, device=tgt.device)

    # Index-aligned RMSE over sample 0's prefix (reference monitor).
    m0 = (slot < counts[0]).to(torch.float32)[:, None]
    diff0 = (pred_vertices[0] - tgt[0]) * m0
    sq0, n0 = torch.sum(diff0 * diff0), torch.sum(m0) * 3.0
    if not first:
        sq0, n0 = torch.zeros_like(sq0), torch.zeros_like(n0)

    # Hungarian RMSE over the whole batch using the loss's matching.
    matched_cols = losses["matched_cols"]
    matched = matched_cols < counts[:, None]
    safe = torch.where(matched, matched_cols,
                       torch.zeros_like(matched_cols)).long()
    tgt_m = torch.take_along_dim(tgt, safe[..., None], dim=1)
    d = (pred_vertices - tgt_m) * matched[..., None].to(torch.float32)

    # Edge precision / recall against the labels the edge BCE used.
    mask = losses["pair_mask_eff"]
    pred_pos = (edge_probs > thresh).to(torch.float32) * mask
    pos = losses["edge_labels_eff"] * mask
    return torch.stack([
        losses["total_loss"].detach().float(),
        losses["vertex_loss"].detach().float(),
        losses["existence_loss"].detach().float(),
        losses["edge_loss"].detach().float(),
        sq0, n0, torch.sum(d * d),
        torch.sum(matched.to(torch.float32)) * 3.0,
        torch.sum(pred_pos * pos), torch.sum(pred_pos), torch.sum(pos)])


def _metrics(sums: torch.Tensor) -> Dict[str, torch.Tensor]:
    s = dict(zip(_SUMS, sums.unbind()))
    p = s["tp"] / torch.clamp_min(s["pred_pos"], 1.0)
    r = s["tp"] / torch.clamp_min(s["pos"], 1.0)
    return {
        "total_loss": s["total_loss"], "vertex_loss": s["vertex_loss"],
        "existence_loss": s["existence_loss"], "edge_loss": s["edge_loss"],
        "vertex_rmse": torch.sqrt(s["sq0"] / torch.clamp_min(s["n0"], 1.0)),
        "hungarian_rmse": torch.sqrt(s["hsq"]
                                     / torch.clamp_min(s["hn"], 1.0)),
        "train_edge_precision": p, "train_edge_recall": r,
        "train_edge_f1": 2.0 * p * r / torch.clamp_min(p + r, 1e-9)}


def loss_config(cfg) -> WireframeLossConfig:
    """The loss settings of `cfg.train`."""
    t = cfg.train
    return WireframeLossConfig(
        vertex_weight=t.vertex_weight, edge_weight=t.edge_weight,
        existence_weight=t.existence_weight, matcher=t.matcher,
        matched_edge_labels=t.matched_edge_labels,
        matched_existence_labels=t.matched_existence_labels)


def point_param_names(model) -> set:
    """The names of the point MLP's parameters: the encoder's stages and
    projection, which an mp group's ranks differentiate slice by slice."""
    return {"encoder." + k for k, _ in
            model.encoder.named_parameters(recurse=False)}


def make_train_step(cfg, steps_per_epoch: int = 1,
                    layout: Optional[Layout] = None) -> Callable:
    """Returns train_step(state, batch, generator) -> (state, metrics).

    batch: the `BATCH_KEYS` tensors on the model's device (with `layout`,
    the rows of this rank's dp index, `parallel.mesh.local_rows`, whole
    clouds); generator: a torch.Generator on that device (augmentation
    and dropout draws; with `layout`, seeded alike on every rank).  The
    state is updated in place and returned.
    """
    if cfg.model.encoder == "ptv2":
        raise ValueError("model.encoder=ptv2 runs at inference only: its "
                         "training step is ROADMAP X-ptv2-train")
    loss_cfg = loss_config(cfg)
    do_augment = cfg.train.device_augment and cfg.data.augment
    optimizer = Optimizer(cfg, steps_per_epoch)
    split = layout if layout is not None and layout.mp > 1 else None

    def global_norms(total_matches, max_pairs, local_batch):
        group = layout.dp_group
        return (all_reduce(total_matches.clone(), "sum", group),
                all_reduce(max_pairs.clone(), "max", group),
                local_batch * layout.dp)

    def reduce_grads(state, grads):
        if split is None:
            flat_apply(grads.values(), all_reduce)
            return
        point = point_param_names(state.model)
        flat_apply([g for k, g in grads.items() if k in point], all_reduce)
        flat_apply([g for k, g in grads.items() if k not in point],
                   lambda t: all_reduce(t, group=layout.dp_group))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        point_clouds = batch["point_clouds"]
        target_vertices = batch["target_vertices"]
        b = point_clouds.shape[0]
        if do_augment:
            with span("augment"):
                point_clouds, target_vertices = augment_batch(
                    generator, point_clouds, target_vertices,
                    rot_degrees=cfg.train.aug_rot_degrees,
                    jitter_std=cfg.train.aug_jitter_std,
                    scale_range=cfg.train.aug_scale_range,
                    rows=None if layout is None else layout.rows(b))
        work = dict(batch, point_clouds=point_clouds,
                    target_vertices=target_vertices)
        with span("forward"):
            preds = state.model(work["point_clouds"], work["vertex_counts"],
                                train=True, generator=generator, split=split)
        targets = {"vertices": work["target_vertices"],
                   "vertex_existence": work["vertex_existence"],
                   "edge_labels": work["edge_labels"],
                   "vertex_counts": work["vertex_counts"]}
        norms = (None if layout is None else
                 lambda t, m: global_norms(t, m, b))
        with span("loss"):
            losses = wireframe_loss(preds, targets, loss_cfg, norms=norms)
        params = state.params
        names = list(params)
        with span("backward"):
            grads = torch.autograd.grad(losses["total_loss"],
                                        [params[k] for k in names],
                                        allow_unused=True)
            # A parameter the loss does not reach has a zero gradient, as
            # jax.grad gives it.
            grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                     for k, g in zip(names, grads)}
        if layout is not None:
            reduce_grads(state, grads)
        with span("optimizer"):
            g_norm = global_norm(grads.values())
            optimizer.apply(state, grads, g_norm)

        with torch.no_grad():
            sums = _metric_sums(preds["vertices"].detach(), work, losses,
                                preds["edge_probs"].detach(),
                                first=layout is None or layout.dp_rank == 0)
            if layout is not None:
                all_reduce(sums, group=layout.dp_group)
            metrics = _metrics(sums)
        metrics["grad_norm"] = g_norm
        if OVERFLOW in preds:
            # Every step's overflow, not only the logged one's: the count
            # since the counters' reset, which the loop raises on.
            metrics[OVERFLOW] = state.model.encoder.backbone.overflowed()
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
