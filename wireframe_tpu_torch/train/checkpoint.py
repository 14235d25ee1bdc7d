"""Training checkpoints: save, find, restore, warm-start.

Port of `wireframe_tpu/train/checkpoint.py`, in numpy `.npz` files and
JSON instead of orbax (no torch pickles).  Under a checkpoint directory
D, `save_checkpoint` writes

    D/step_<N>/params.npz      the params under flax paths, with
    D/step_<N>/config.json     the config: together a port checkpoint
                               that `serve.WireframePredictor` serves;
    D/step_<N>/opt_state.npz   Adam's moments (mu/<path>, nu/<path>, in
                               the params' layout) and its count;
    D/step_<N>.meta.json       step, epoch, max_vertices, input_dim and
                               the config, as the JAX package writes it.

N is the OPTIMIZER step (monotonic across mid-run and final saves, so
`latest_step` orders them); `epoch`, the completed-epoch count, is the
resume point and differs from N whenever an epoch has several batches.

A checkpoint holds what the JAX package's holds: no EMA.  A restore
re-seeds the EMA from the restored params, as the JAX `main.py --resume`
does; the EMA weights of a finished run are kept as a params-only
checkpoint (`save_params_checkpoint`, no opt_state.npz) under `D/ema`.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wireframe_tpu_torch.bridge import (
    load_port_checkpoint,
    params_from_flax,
    save_port_checkpoint,
    state_dict_to_flax,
)
from wireframe_tpu_torch.config import (
    Config,
    apply_saved_model_config,
    config_to_dict,
)
from wireframe_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)


def _save_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def _load_npz(path: str) -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _write_checkpoint(directory: str, step: int,
                      params: Dict[str, torch.Tensor], cfg: Config,
                      epoch: Optional[int],
                      opt: Optional[Dict[str, np.ndarray]] = None) -> str:
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    m = cfg.model
    save_port_checkpoint(path, state_dict_to_flax(params, m), cfg)
    if opt is not None:
        _save_npz(os.path.join(path, "opt_state.npz"), opt)
    meta = {"step": int(step), "max_vertices": m.max_vertices,
            "input_dim": m.input_dim, "config": config_to_dict(cfg)}
    if epoch is not None:
        meta["epoch"] = int(epoch)
    # The metadata last: a step directory without it is incomplete.
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


def save_checkpoint(directory: str, state: TrainState, cfg: Config,
                    epoch: Optional[int] = None) -> str:
    """Write `directory/step_<state.step>` (params and Adam state); returns
    its path."""
    opt = {"count": np.asarray(state.step, np.int64)}
    for name, moments in (("mu", state.mu), ("nu", state.nu)):
        for k, v in state_dict_to_flax(moments, cfg.model).items():
            opt[f"{name}/{k}"] = v
    return _write_checkpoint(directory, state.step, state.params, cfg, epoch,
                             opt)


def save_params_checkpoint(directory: str, step: int,
                           params: Dict[str, torch.Tensor], cfg: Config,
                           epoch: Optional[int] = None) -> str:
    """Write `params` (by parameter name) as a params-only checkpoint
    `directory/step_<step>`, without optimizer state: what the JAX
    package's `save_checkpoint(..., opt_state=None)` writes, and what
    `evaluate` reads unchanged.  Returns its path."""
    return _write_checkpoint(directory, step, params, cfg, epoch)


def latest_step(directory: str) -> Optional[int]:
    """The largest N of the `step_<N>` checkpoints under `directory`."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".meta.json"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None
                    ) -> Tuple[dict, dict]:
    """Returns (payload, metadata) of `step` (default: the latest).
    payload: params (flat flax paths), mu / nu (the same, or None) and
    count (int or None); None for a params-only checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    params, _ = load_port_checkpoint(path)
    opt = _load_npz(os.path.join(path, "opt_state.npz"))
    payload = {"params": params, "mu": None, "nu": None, "count": None}
    if opt is not None:
        payload["count"] = int(opt.pop("count"))
        for name in ("mu", "nu"):
            payload[name] = {k[len(name) + 1:]: v for k, v in opt.items()
                             if k.startswith(name + "/")}
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return payload, meta


def _named(flat: Dict[str, np.ndarray], like: Dict[str, torch.Tensor],
           what: str) -> Dict[str, torch.Tensor]:
    """Flat flax-path arrays -> tensors named and placed as `like`; the
    names and shapes must match exactly."""
    named = params_from_flax(flat)
    if set(named) != set(like):
        raise ValueError(f"{what}: checkpoint names differ from the model's "
                         f"({sorted(set(named) ^ set(like))[:4]} ...)")
    out = {}
    for k, ref in like.items():
        if named[k].shape != ref.shape:
            raise ValueError(f"{what}: {k} has shape {tuple(named[k].shape)}"
                             f", the configured model {tuple(ref.shape)}")
        out[k] = named[k].to(device=ref.device, dtype=torch.float32)
    return out


def restore_train_state(state: TrainState, directory: str,
                        step: Optional[int] = None) -> Tuple[TrainState, int]:
    """Load a checkpoint's params, Adam moments and count into `state` (a
    fresh state of the same architecture, on its device), in place; the
    EMA, when the run keeps one, restarts from the restored params (the
    JAX package does not checkpoint the EMA trajectory).  Returns (state,
    start_epoch): the completed epochs, or the step for a checkpoint
    without an epoch (the overfit regime)."""
    payload, meta = load_checkpoint(directory, step)
    params = state.params
    with torch.no_grad():
        for k, v in _named(payload["params"], params, "params").items():
            params[k].copy_(v)
    if payload["mu"] is not None:
        state.mu = _named(payload["mu"], params, "Adam mu")
        state.nu = _named(payload["nu"], params, "Adam nu")
        state.step = payload["count"]
    else:
        state.step = int(meta.get("step", 0))
    if state.ema_params is not None:
        state.ema_params = {k: p.detach().clone() for k, p in params.items()}
    return state, int(meta.get("epoch", meta.get("step", 0)))


def warm_start_params(state: TrainState, directory: str) -> TrainState:
    """`train.init_from`: the latest checkpoint's params, with the fresh
    optimizer state and step counter of `state`; the EMA re-seeds from the
    loaded weights.  An architecture mismatch raises."""
    payload, _ = load_checkpoint(directory)
    params = state.params
    loaded = _named(payload["params"], params, "init_from")
    with torch.no_grad():
        for k, v in loaded.items():
            params[k].copy_(v)
    if state.ema_params is not None:
        state.ema_params = {k: v.clone() for k, v in loaded.items()}
    return state


def apply_checkpoint_model_config(cfg: Config, meta: dict) -> Config:
    """Overwrite cfg's model architecture (and the input-feature
    semantics) from checkpoint metadata; warn about model keys the
    checkpoint predates."""
    saved = meta.get("config", {})
    model = saved.get("model")
    if model:
        stale = sorted(k for k in vars(cfg.model) if k not in model)
        if stale:
            logger.warning(
                "checkpoint metadata predates model config key(s) %s; "
                "restoring with current defaults — verify they match the "
                "training-time behavior", ", ".join(stale))
    elif meta.get("max_vertices"):
        cfg.model.max_vertices = int(meta["max_vertices"])
        saved = dict(saved, model={"max_vertices": cfg.model.max_vertices})
    return apply_saved_model_config(cfg, saved)
