"""Training loop on one device.

Port of `wireframe_tpu/train/loop.py:train_model`: by default it takes
ONE batch and overfits it for `num_epochs` steps (the reference regime,
train.py:25); `train.overfit_one_batch=False` runs epochs over the
loader.  Best loss and best RMSE are tracked at the log points (every
`log_every` epochs and the last), where the metrics are read back from
the device; `save_best` keeps the PRE-update params of the best logged
step (the step's metrics come from them) and writes them as a port
checkpoint under `<checkpoint_dir>/best`.  The logged learning rate is
the one the logged step applied.

Every `checkpoint_every` epochs (before the last) the loop writes a
checkpoint (`train.checkpoint`: params, Adam state, step and epoch)
under `checkpoint_dir`; `state=` + `start_epoch=` resume from one.  The
augmentation / dropout generator is seeded from (train.seed,
start_epoch), as the JAX loop folds start_epoch into its key, so two
resumes from one checkpoint give the same run.  A fresh run with
`train.init_from` warm-starts the params from that checkpoint directory
with a fresh optimizer.

`loader` is any iterable of numpy batch dicts holding `BATCH_KEYS` (a
list of one batch will do in overfit mode); a loader with an `epoch`
attribute is fast-forwarded to start_epoch.  Mesh placement (ROADMAP.md
A7) is not ported.  The loop returns the final state.
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, Optional

import numpy as np
import torch

from wireframe_tpu_torch.bridge import (
    init_flax_params,
    params_from_flax,
    save_port_checkpoint,
    state_dict_to_flax,
)
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.train.checkpoint import (
    save_checkpoint,
    warm_start_params,
)
from wireframe_tpu_torch.train.state import TrainState, create_train_state
from wireframe_tpu_torch.train.step import BATCH_KEYS, make_train_step
from wireframe_tpu_torch.utils.platform import resolve_device

logger = logging.getLogger(__name__)


def device_batch(batch: dict, device) -> dict:
    """The `BATCH_KEYS` arrays of a numpy batch as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS}


def init_model(cfg, device, seed: Optional[int] = None
               ) -> PointCloudToWireframe:
    """The model with random weights at flax's init scales from a numpy
    seed (default cfg.train.seed), on `device`."""
    model = PointCloudToWireframe(cfg.model)
    flax = init_flax_params(cfg.model,
                            cfg.train.seed if seed is None else seed)
    model.load_state_dict(params_from_flax(flax), strict=True)
    return model.to(device)


def epoch_seed(seed: int, start_epoch: int) -> int:
    """The generator seed of a run that starts at `start_epoch`."""
    seq = np.random.SeedSequence([seed, start_epoch])
    return int(seq.generate_state(1)[0])


def train_model(cfg, loader: Iterable, metric_writer=None,
                state: Optional[TrainState] = None, start_epoch: int = 0,
                device=None,
                generator: Optional[torch.Generator] = None) -> TrainState:
    """Train epochs start_epoch .. num_epochs - 1 and return the final
    TrainState.

    state: a restored state to continue (`checkpoint.restore_train_state`)
    on `device`; None starts fresh (from `train.init_from` when set).
    device: "cuda" (default; raises without a GPU) or "cpu".  generator:
    the augmentation / dropout draws (default: seeded on the device from
    `epoch_seed(train.seed, start_epoch)`).  metric_writer: anything with
    `.log(dict)`, called at the log points.
    """
    dev = resolve_device(device)
    try:
        n_batches = len(loader)
    except TypeError:        # a loader without a length
        n_batches = None
    if n_batches == 0:
        raise ValueError("loader yields no batches")
    steps_per_epoch = (1 if cfg.train.overfit_one_batch or n_batches is None
                       else n_batches)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(epoch_seed(cfg.train.seed, start_epoch))

    t0 = time.time()
    if state is None:
        state = create_train_state(cfg, init_model(cfg, dev))
        if cfg.train.init_from:
            warm_start_params(state, cfg.train.init_from)
            logger.info("Initialized params from %s", cfg.train.init_from)
    logger.info("Model parameters: %s",
                f"{sum(p.numel() for p in state.model.parameters()):,}")
    state.model.train()
    train_step = make_train_step(cfg, steps_per_epoch)
    optimizer = train_step.optimizer

    best_loss = float("inf")
    best_rmse = float("inf")
    best_params = None
    if hasattr(loader, "epoch"):
        loader.epoch = start_epoch      # deterministic data order on resume
    fixed = (device_batch(next(iter(loader)), dev)
             if cfg.train.overfit_one_batch else None)

    num_epochs = cfg.train.num_epochs
    every = cfg.train.checkpoint_every
    metrics = None
    for epoch in range(start_epoch, num_epochs):
        batches = [fixed] if fixed is not None else (
            device_batch(b, dev) for b in loader)
        is_log_epoch = (epoch % cfg.train.log_every == 0
                        or epoch == num_epochs - 1)
        pre_params = None
        for batch in batches:
            if is_log_epoch and cfg.train.save_best:
                # The step's metrics come from the PRE-update params.
                pre_params = {k: p.detach().clone()
                              for k, p in state.params.items()}
            state, metrics = train_step(state, batch, generator)

        if is_log_epoch and metrics is not None:
            m = {k: float(v) for k, v in metrics.items()}
            if (cfg.train.save_best and pre_params is not None
                    and m["total_loss"] < best_loss):
                best_params = pre_params
            best_loss = min(best_loss, m["total_loss"])
            best_rmse = min(best_rmse, m["vertex_rmse"])
            elapsed = time.time() - t0
            logger.info(
                "Epoch %4d/%d | Loss: %.6f | RMSE: %.6f | H-RMSE: %.6f | "
                "Time: %.1fs", epoch, num_epochs, m["total_loss"],
                m["vertex_rmse"], m["hungarian_rmse"], elapsed)
            if metric_writer is not None:
                metric_writer.log({
                    "epoch": epoch,
                    **{k: m[k] for k in (
                        "total_loss", "vertex_loss", "existence_loss",
                        "edge_loss", "vertex_rmse", "hungarian_rmse",
                        "train_edge_f1", "train_edge_precision",
                        "train_edge_recall")},
                    # The LR the logged step applied (index step - 1).
                    "learning_rate": optimizer.lr(max(state.step - 1, 0)),
                    "elapsed_time": elapsed,
                    "best_loss": best_loss,
                    "best_vertex_rmse": best_rmse,
                })
        if every > 0 and (epoch + 1) % every == 0 and epoch + 1 < num_epochs:
            path = save_checkpoint(cfg.train.checkpoint_dir, state, cfg,
                                   epoch=epoch + 1)
            logger.info("Checkpoint written: %s", path)

    logger.info("Training completed! Best loss: %.6f, Best RMSE: %.6f",
                best_loss, best_rmse)
    if cfg.train.save_best and best_params is not None:
        path = cfg.train.checkpoint_dir + "/best"
        save_port_checkpoint(path, state_dict_to_flax(best_params, cfg.model),
                             cfg)
        logger.info("Best-loss checkpoint written: %s", path)
    return state
