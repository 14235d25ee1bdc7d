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
`write_flax_checkpoint` writes the same files from flax-layout arrays:
the repository's `export_port_checkpoint.py` turns a JAX package's orbax
checkpoint into one with it.

The reference's `.pth` import (`load_torch_checkpoint_as_params`) is a
copy of the JAX package's numpy transplant: the reference model's
state_dict -> a flax tree of the parity model, which `params_from_flax`
takes like any other.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wireframe_tpu_torch.bridge import (
    flax_param_shapes,
    load_port_checkpoint,
    params_from_flax,
    save_port_checkpoint,
    state_dict_to_flax,
)
from wireframe_tpu_torch.config import (
    Config,
    apply_saved_model_config,
    config_to_dict,
    unused_model_keys,
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


def write_flax_checkpoint(directory: str, step: int,
                          params: Dict[str, np.ndarray], cfg: Config,
                          epoch: Optional[int] = None,
                          adam: Optional[Tuple[dict, dict, int]] = None,
                          meta: Optional[dict] = None) -> str:
    """Write `directory/step_<step>` from flat flax-path arrays: the params
    and, given `adam` = (mu, nu, count) in the params' layout, Adam's
    state.  The arrays must be the tree of `cfg.model`.  `meta` replaces
    the metadata's config, max_vertices and input_dim (an exported
    checkpoint keeps its own).  Returns the path."""
    want = flax_param_shapes(cfg.model)
    for what, tree in (("params", params), *(
            (f"Adam {n}", t) for n, t in zip(("mu", "nu"), adam or ()))):
        got = {k: tuple(np.shape(v)) for k, v in tree.items()}
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))[:4]
            raise ValueError(f"{what}: not the tree of the configured model "
                             f"({diff} ...)")
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    m = cfg.model
    save_port_checkpoint(path, params, cfg)
    if adam is not None:
        mu, nu, count = adam
        opt = {"count": np.asarray(count, np.int64)}
        for name, tree in (("mu", mu), ("nu", nu)):
            for k, v in tree.items():
                opt[f"{name}/{k}"] = np.asarray(v, np.float32)
        _save_npz(os.path.join(path, "opt_state.npz"), opt)
    info = {"step": int(step), "max_vertices": m.max_vertices,
            "input_dim": m.input_dim, "config": config_to_dict(cfg)}
    info.update((k, meta[k]) for k in ("max_vertices", "input_dim",
                                       "config") if k in (meta or {}))
    if epoch is not None:
        info["epoch"] = int(epoch)
    # The metadata last: a step directory without it is incomplete.
    with open(path + ".meta.json", "w") as f:
        json.dump(info, f, indent=2)
    return path


def with_buffers(model, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """`params` with the model's buffers beside them (the ptv3 backbone's
    BatchNorm running statistics), which a checkpoint keeps too."""
    return {**dict(model.named_buffers()), **params}


def save_checkpoint(directory: str, state: TrainState, cfg: Config,
                    epoch: Optional[int] = None) -> str:
    """Write `directory/step_<state.step>` (params and Adam state); returns
    its path."""
    flax = [state_dict_to_flax(t, cfg.model)
            for t in (with_buffers(state.model, state.params), state.mu,
                      state.nu)]
    return write_flax_checkpoint(directory, state.step, flax[0], cfg, epoch,
                                 adam=(flax[1], flax[2], state.step))


def save_params_checkpoint(directory: str, step: int,
                           params: Dict[str, torch.Tensor], cfg: Config,
                           epoch: Optional[int] = None) -> str:
    """Write `params` (by parameter name) as a params-only checkpoint
    `directory/step_<step>`, without optimizer state: what the JAX
    package's `save_checkpoint(..., opt_state=None)` writes, and what
    `evaluate` reads unchanged.  Returns its path."""
    return write_flax_checkpoint(directory, step,
                                 state_dict_to_flax(params, cfg.model), cfg,
                                 epoch)


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
        # A tree leaves out the port-only keys its backbone does not read
        # (a pointnet tree all of them) by design.
        skip = unused_model_keys(model.get("encoder", "pointnet"))
        stale = sorted(k for k in vars(cfg.model)
                       if k not in model and k not in skip)
        if stale:
            logger.warning(
                "checkpoint metadata predates model config key(s) %s; "
                "restoring with current defaults — verify they match the "
                "training-time behavior", ", ".join(stale))
    elif meta.get("max_vertices"):
        cfg.model.max_vertices = int(meta["max_vertices"])
        saved = dict(saved, model={"max_vertices": cfg.model.max_vertices})
    return apply_saved_model_config(cfg, saved)


# ---------------------------------------------------------------------------
# The reference's PyTorch `.pth` (a copy of the JAX package's numpy
# transplant, wireframe_tpu/train/checkpoint.py:174-304).
# ---------------------------------------------------------------------------

def import_torch_state_dict(pth_path: str):
    """Load the reference's `.pth` as (state_dict_numpy, max_vertices)."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    out = {k: v.detach().numpy() for k, v in sd.items()}
    final = out.get("vertex_predictor.final_layer.weight")
    max_vertices = final.shape[0] // 4 if final is not None else None
    return out, max_vertices


def torch_to_flax_params(sd: dict, num_heads: int = 8) -> dict:
    """Full weight transplantation: reference PyTorch state_dict -> flax
    params for the reference-parity model (model.vertex_head="mlp").

    Layout rules (every torch Linear weight is (out, in); flax Dense
    kernels are (in, out), hence the transposes):
      encoder.mlp.{4i}/{4i+1}      -> encoder/stage{i}_* (Linear + LN)
      encoder.mlp.16               -> encoder/proj_*
      encoder.feature_fusion.{0,3,6}/{1,4} -> encoder/fusion Dense_{0,1,2}
                                              + LayerNorm_{0,1}
      vertex_predictor.vertex_mlp{k}.{0,1} -> vertex_predictor/mlp{k}
      final_layer / residual_proj{1,2} / point_pool_proj -> same names
        (point_pool_proj exists in the state_dict only if a forward ran
        before torch.save: the reference creates it lazily)
      edge_predictor.vertex_proj.{0,3}/{1,4} -> edge Dense_{0,1} + LN_{0,1}
      edge_predictor.attention     -> packed in_proj_weight (3H, H) split
        into flax query/key/value kernels (H, heads, head_dim); out_proj
        -> out kernel (heads, head_dim, H)
      edge_predictor.edge_mlp.{0,4,8,10}/{1,5} -> edge Dense_{2..5}
        + LayerNorm_{2,3}
      edge_predictor.spatial_proj  -> dead in the reference (never
        called), skipped.
    """
    def t(key):  # torch Linear weight -> flax kernel
        return np.asarray(sd[key]).T.copy()

    def v(key):
        return np.asarray(sd[key]).copy()

    def dense(prefix):
        return {"kernel": t(prefix + ".weight"), "bias": v(prefix + ".bias")}

    def ln(prefix):
        return {"scale": v(prefix + ".weight"), "bias": v(prefix + ".bias")}

    encoder = {}
    n_stages = 0
    while f"encoder.mlp.{4 * n_stages}.weight" in sd and (
            f"encoder.mlp.{4 * n_stages + 1}.weight" in sd):
        i = n_stages
        encoder[f"stage{i}_w"] = t(f"encoder.mlp.{4 * i}.weight")
        encoder[f"stage{i}_b"] = v(f"encoder.mlp.{4 * i}.bias")
        encoder[f"stage{i}_ln_scale"] = v(f"encoder.mlp.{4 * i + 1}.weight")
        encoder[f"stage{i}_ln_bias"] = v(f"encoder.mlp.{4 * i + 1}.bias")
        n_stages += 1
    encoder["proj_w"] = t(f"encoder.mlp.{4 * n_stages}.weight")
    encoder["proj_b"] = v(f"encoder.mlp.{4 * n_stages}.bias")
    encoder["fusion"] = {
        "Dense_0": dense("encoder.feature_fusion.0"),
        "LayerNorm_0": ln("encoder.feature_fusion.1"),
        "Dense_1": dense("encoder.feature_fusion.3"),
        "LayerNorm_1": ln("encoder.feature_fusion.4"),
        "Dense_2": dense("encoder.feature_fusion.6"),
    }

    vertex = {
        "final_layer": dense("vertex_predictor.final_layer"),
        "residual_proj1": dense("vertex_predictor.residual_proj1"),
        "residual_proj2": dense("vertex_predictor.residual_proj2"),
    }
    for k in (1, 2, 3, 4):
        vertex[f"mlp{k}"] = {
            "Dense_0": dense(f"vertex_predictor.vertex_mlp{k}.0"),
            "LayerNorm_0": ln(f"vertex_predictor.vertex_mlp{k}.1"),
        }
    if "vertex_predictor.point_pool_proj.weight" in sd:
        vertex["point_pool_proj"] = dense("vertex_predictor.point_pool_proj")
    else:
        raise KeyError(
            "state_dict lacks vertex_predictor.point_pool_proj — the "
            "reference creates it lazily on the first forward; run one "
            "forward before torch.save")

    in_w = np.asarray(sd["edge_predictor.attention.in_proj_weight"])
    in_b = np.asarray(sd["edge_predictor.attention.in_proj_bias"])
    h = in_w.shape[1]
    head_dim = h // num_heads

    def qkv(part):
        w = in_w[part * h:(part + 1) * h]   # (H_out, H_in) torch layout
        b = in_b[part * h:(part + 1) * h]
        return {"kernel": w.T.reshape(h, num_heads, head_dim).copy(),
                "bias": b.reshape(num_heads, head_dim).copy()}

    out_w = np.asarray(sd["edge_predictor.attention.out_proj.weight"])
    attention = {
        "query": qkv(0),
        "key": qkv(1),
        "value": qkv(2),
        "out": {
            "kernel": out_w.T.reshape(num_heads, head_dim, h).copy(),
            "bias": v("edge_predictor.attention.out_proj.bias"),
        },
    }

    edge = {
        "Dense_0": dense("edge_predictor.vertex_proj.0"),
        "LayerNorm_0": ln("edge_predictor.vertex_proj.1"),
        "Dense_1": dense("edge_predictor.vertex_proj.3"),
        "LayerNorm_1": ln("edge_predictor.vertex_proj.4"),
        "attention": attention,
        "Dense_2": dense("edge_predictor.edge_mlp.0"),
        "LayerNorm_2": ln("edge_predictor.edge_mlp.1"),
        "Dense_3": dense("edge_predictor.edge_mlp.4"),
        "LayerNorm_3": ln("edge_predictor.edge_mlp.5"),
        "Dense_4": dense("edge_predictor.edge_mlp.8"),
        "Dense_5": dense("edge_predictor.edge_mlp.10"),
    }

    return {"encoder": encoder, "vertex_predictor": vertex,
            "edge_predictor": edge}


def load_torch_checkpoint_as_params(pth_path: str, num_heads: int = 8):
    """One-call import: reference `.pth` -> (flax params, max_vertices)."""
    sd, max_vertices = import_torch_state_dict(pth_path)
    return torch_to_flax_params(sd, num_heads=num_heads), max_vertices
