#!/usr/bin/env python3
"""Export a JAX package checkpoint (orbax) as a checkpoint of the
PyTorch/CUDA port.

    JAX_PLATFORMS=cpu python export_port_checkpoint.py \\
        --checkpoint-dir <jax checkpoint dir> [--step N] --out-dir <port dir>

Reads `<jax dir>/step_N` (default: the latest step) and its
`step_N.meta.json`, and writes the port's training-checkpoint layout
(`wireframe_tpu_torch/train/checkpoint.py`):

    <out>/step_N/params.npz      the params by flax path;
    <out>/step_N/config.json     the config of the checkpoint's metadata;
    <out>/step_N/opt_state.npz   Adam's mu / nu by flax path and its count,
                                 when the JAX checkpoint holds opt_state;
    <out>/step_N.meta.json       step, epoch, max_vertices, input_dim and
                                 config, as the JAX metadata has them;
    <out>/ema/step_M             the params-only EMA checkpoint, when
                                 `<jax dir>/ema` exists (M = N when it has
                                 that step, else its latest).

The port's `serve`, `evaluate`, `test`, `main --resume` and
`train.init_from` read the result unchanged, on the card.  Every model
the JAX package builds exports: the query decoder in each layout
(unrolled, `decoder_fused_cross_kv`, `decoder_scan`, both) and the MLP
head.  The Adam state is restored against a template of
`wireframe_tpu.train.state.create_train_state` for the checkpoint's
config (optax keeps NamedTuples, which orbax returns as plain dicts
without one); under `train.flatten_optimizer` its moments are single
vectors, unravelled by the params' `ravel_pytree` before they are written
by flax path.

This script reads orbax, so it runs where JAX runs (the CPU will do) and
not on a machine that has only the port.  Copy its output there.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint-dir", required=True,
                   help="the JAX package's checkpoint directory (main.py "
                        "--checkpoint-dir)")
    p.add_argument("--step", type=int, default=None,
                   help="the step to export (default: the latest)")
    p.add_argument("--out-dir", required=True,
                   help="where to write the port checkpoint")
    return p.parse_args(argv)


def _from_saved(cfg, saved: dict):
    """`cfg` (either package's Config) with every key of a saved
    `config_to_dict` tree that it knows."""
    for section, values in saved.items():
        sec = getattr(cfg, section, None)
        for key, value in (values or {}).items():
            if sec is not None and hasattr(sec, key):
                current = getattr(sec, key)
                setattr(sec, key,
                        tuple(value) if isinstance(current, tuple) else value)
    cfg.__post_init__()
    return cfg


def _adam_state(directory: str, step: int, cfg):
    """(mu, nu, count) of the checkpoint's `scale_by_adam` state, the
    moments as flat flax-path arrays."""
    import jax
    import numpy as np
    import optax
    from jax.flatten_util import ravel_pytree

    from wireframe_tpu.train.checkpoint import load_checkpoint
    from wireframe_tpu.train.state import create_train_state
    from wireframe_tpu_torch.bridge import flatten_params

    shape = (1, cfg.data.num_points, cfg.model.input_dim)
    abstract = jax.eval_shape(
        lambda: create_train_state(cfg, jax.random.PRNGKey(0), shape))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        {"params": abstract.params, "opt_state": abstract.opt_state})
    payload, _ = load_checkpoint(directory, step, template=template)
    adam = [s for s in jax.tree_util.tree_leaves(
        payload["opt_state"],
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if len(adam) != 1:
        raise ValueError(f"{directory}/step_{step}: expected one "
                         f"scale_by_adam state, found {len(adam)}")
    mu, nu = adam[0].mu, adam[0].nu
    if cfg.train.flatten_optimizer:        # optax.flatten: one vector each
        unravel = ravel_pytree(payload["params"])[1]
        mu, nu = unravel(mu), unravel(nu)
    as_np = lambda t: flatten_params(jax.tree_util.tree_map(np.asarray, t))
    return as_np(mu), as_np(nu), int(adam[0].count)


def export(checkpoint_dir: str, out_dir: str, step=None) -> str:
    """Write the port checkpoint of `checkpoint_dir`'s `step` (default
    latest) and its EMA under `out_dir`; returns the step's path."""
    import jax
    import numpy as np

    from wireframe_tpu.config import Config, config_to_dict
    from wireframe_tpu.train.checkpoint import (
        apply_checkpoint_model_config,
        latest_step,
        load_checkpoint,
    )
    from wireframe_tpu_torch import config as port_config
    from wireframe_tpu_torch.bridge import flatten_params
    from wireframe_tpu_torch.train.checkpoint import write_flax_checkpoint

    if step is None:
        step = latest_step(checkpoint_dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {checkpoint_dir}")
    payload, meta = load_checkpoint(checkpoint_dir, step)
    # The config the checkpoint was written under; the model through
    # apply_checkpoint_model_config, which warns about keys it predates.
    cfg = apply_checkpoint_model_config(
        _from_saved(Config(), meta.get("config", {})), meta)
    port_cfg = _from_saved(port_config.Config(), config_to_dict(cfg))
    params = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                   payload["params"]))
    adam = (_adam_state(checkpoint_dir, step, cfg)
            if "opt_state" in payload else None)
    path = write_flax_checkpoint(out_dir, step, params, port_cfg,
                                 meta.get("epoch"), adam=adam, meta=meta)
    print(f"exported {checkpoint_dir}/step_{step} -> {path} "
          f"({len(params)} params, "
          f"{'with' if adam else 'without'} Adam state)")

    ema_dir = os.path.join(checkpoint_dir, "ema")
    if os.path.isdir(ema_dir):
        ema_step = (step if os.path.isdir(os.path.join(ema_dir,
                                                       f"step_{step}"))
                    else latest_step(ema_dir))
        ema, ema_meta = load_checkpoint(ema_dir, ema_step)
        ema_params = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                           ema["params"]))
        ema_path = write_flax_checkpoint(
            os.path.join(out_dir, "ema"), ema_step, ema_params, port_cfg,
            ema_meta.get("epoch"), meta=ema_meta)
        print(f"exported {ema_dir}/step_{ema_step} -> {ema_path}")
    return path


def main(argv=None) -> int:
    from wireframe_tpu.utils.platform import honor_env_platform

    honor_env_platform()
    logging.basicConfig(level=logging.WARNING)
    args = parse_args(argv)
    export(args.checkpoint_dir, args.out_dir, args.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
