"""Weight carry-over between the JAX package's flax tree and the port.

A flax parameter tree is keyed by paths such as `encoder/stage0_w` or
`vertex_decoder/block0/self_attn/query/kernel`.  `params_from_flax` turns
it into the port's `state_dict`:
- Dense kernels (in, out) become torch weights (out, in);
- attention DenseGeneral kernels (D, H, hd) / biases (H, hd) become
  (H*hd, D) / (H*hd,), and the output kernel (H, hd, D) becomes (D, H*hd);
- LayerNorm `scale` becomes `weight`;
- raw parameters (encoder stages, slot queries, the PairDense kernel,
  whose rows are split by meaning) keep their layout.

`state_dict_to_flax` is its inverse, so a state_dict trained by the port
is written as a port checkpoint (`save_port_checkpoint`) that
`serve.WireframePredictor` serves.

The port's checkpoint is a directory with `params.npz` (flax paths ->
float32 arrays) and `config.json` (`config_to_dict` layout).  Reading
the JAX package's orbax checkpoints needs jax, so that stays out of the
port: a caller with jax saves its params with `save_port_checkpoint`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from wireframe_tpu_torch.config import Config, ModelConfig, config_to_dict

# Kernels kept in flax's (in, out) layout: PairDense splits its rows.
_RAW_KERNELS = ("edge_predictor/Dense_2/kernel",)


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a/b/c": array}; flat dicts pass through."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _torch_entry(path: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    parts = path.split("/")
    leaf, module = parts[-1], ".".join(parts[:-1])
    if path in _RAW_KERNELS or leaf not in ("kernel", "bias", "scale"):
        return ".".join(parts), arr
    if leaf == "scale":
        return f"{module}.weight", arr
    if leaf == "bias":
        return f"{module}.bias", arr.reshape(-1)
    if arr.ndim == 2:
        return f"{module}.weight", arr.T
    if arr.ndim == 3 and parts[-2] == "out":          # (H, hd, D)
        return f"{module}.weight", arr.reshape(-1, arr.shape[-1]).T
    if arr.ndim == 3:                                 # (D, H, hd)
        return f"{module}.weight", arr.reshape(arr.shape[0], -1).T
    raise ValueError(f"unexpected kernel {path} of shape {arr.shape}")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (flat by path, or nested) -> the port's state_dict."""
    state = {}
    for path, arr in flatten_params(params).items():
        key, value = _torch_entry(path, np.asarray(arr, np.float32))
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.array(value, np.float32))
    return state


def state_dict_to_flax(state: Mapping[str, torch.Tensor],
                       cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's state_dict (or named parameters) -> flat flax-path
    float32 arrays, the inverse of `params_from_flax` for the model of
    `cfg`."""
    out = {}
    for path, shape in flax_param_shapes(cfg).items():
        key, ported = _torch_entry(path, np.zeros(shape, np.float32))
        if key not in state:
            raise KeyError(f"state_dict has no {key} (flax {path})")
        arr = state[key].detach().float().cpu().numpy()
        if arr.shape != ported.shape:
            raise ValueError(f"{key}: shape {arr.shape}, expected "
                             f"{ported.shape}")
        leaf = path.rsplit("/", 1)[-1]
        transposed = (leaf == "kernel" and path not in _RAW_KERNELS)
        out[path] = np.ascontiguousarray(
            (arr.T if transposed else arr).reshape(shape), np.float32)
    return out


def flax_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf of the flax `PointCloudToWireframe` tree for `cfg` (the
    query head, unrolled layout) with its shape."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def dense(path, i, o):
        shapes[f"{path}/kernel"] = (i, o)
        shapes[f"{path}/bias"] = (o,)

    def norm(path, d):
        shapes[f"{path}/scale"] = (d,)
        shapes[f"{path}/bias"] = (d,)

    def attention(path, d, heads):
        for name in ("query", "key", "value"):
            shapes[f"{path}/{name}/kernel"] = (d, heads, d // heads)
            shapes[f"{path}/{name}/bias"] = (heads, d // heads)
        shapes[f"{path}/out/kernel"] = (heads, d // heads, d)
        shapes[f"{path}/out/bias"] = (d,)

    prev, c = cfg.input_dim, cfg.encoder_output_dim
    for i, h in enumerate(cfg.encoder_hidden_dims):
        shapes[f"encoder/stage{i}_w"] = (prev, h)
        for k in ("b", "ln_scale", "ln_bias"):
            shapes[f"encoder/stage{i}_{k}"] = (h,)
        prev = h
    shapes["encoder/proj_w"] = (prev, c)
    shapes["encoder/proj_b"] = (c,)
    dense("encoder/fusion/Dense_0", 2 * c, 4 * c)
    norm("encoder/fusion/LayerNorm_0", 4 * c)
    dense("encoder/fusion/Dense_1", 4 * c, 2 * c)
    norm("encoder/fusion/LayerNorm_1", 2 * c)
    dense("encoder/fusion/Dense_2", 2 * c, c)

    d, v = cfg.decoder_dim, cfg.max_vertices
    dense("vertex_decoder/point_proj", c, d)
    norm("vertex_decoder/point_ln", d)
    shapes["vertex_decoder/slot_queries"] = (v, d)
    dense("vertex_decoder/global_proj", c, d)
    for i in range(cfg.decoder_layers):
        blk = f"vertex_decoder/block{i}"
        norm(f"{blk}/ln_self", d)
        attention(f"{blk}/self_attn", d, cfg.decoder_heads)
        norm(f"{blk}/ln_cross", d)
        attention(f"{blk}/cross_attn", d, cfg.decoder_heads)
        norm(f"{blk}/ln_ffn", d)
        dense(f"{blk}/ffn_in", d, cfg.decoder_ffn_dim)
        dense(f"{blk}/ffn_out", cfg.decoder_ffn_dim, d)
    norm("vertex_decoder/out_ln", d)
    dense("vertex_decoder/coord_head", d, 3)
    dense("vertex_decoder/exist_head", d, 1)

    h = cfg.edge_hidden_dim
    e = "edge_predictor"
    dense(f"{e}/Dense_0", 3 + (d if cfg.edge_use_slot_features else 0),
          h // 2)
    norm(f"{e}/LayerNorm_0", h // 2)
    dense(f"{e}/Dense_1", h // 2, h)
    norm(f"{e}/LayerNorm_1", h)
    attention(f"{e}/attention", h, cfg.edge_num_heads)
    dense(f"{e}/Dense_2", 2 * h + 2 * 3 + 1, h)
    norm(f"{e}/LayerNorm_2", h)
    dense(f"{e}/Dense_3", h, h // 2)
    norm(f"{e}/LayerNorm_3", h // 2)
    dense(f"{e}/Dense_4", h // 2, h // 4)
    dense(f"{e}/Dense_5", h // 4, 1)
    return shapes


def init_flax_params(cfg: ModelConfig, seed: int) -> Dict[str, np.ndarray]:
    """Random flax-layout params at flax's init scales, from a numpy seed:
    lecun-normal kernels (truncated normal, fan-in over the input axes),
    zero biases, unit LayerNorm scales, normal(0.02) slot queries."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in flax_param_shapes(cfg).items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel" or leaf.endswith("_w"):
            fan_in = (int(np.prod(shape[:2])) if path.endswith("out/kernel")
                      else shape[0])
            z = rng.standard_normal(shape)
            while np.any(np.abs(z) > 2.0):     # truncate at 2 sigma
                bad = np.abs(z) > 2.0
                z[bad] = rng.standard_normal(int(bad.sum()))
            arr = z * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)
        elif leaf == "slot_queries":
            arr = rng.standard_normal(shape) * 0.02
        elif leaf == "scale" or leaf.endswith("_ln_scale"):
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        out[path] = arr.astype(np.float32)
    return out


def save_port_checkpoint(directory: str, flat_params: Mapping,
                         config) -> None:
    """Write `params.npz` + `config.json` (a Config or its dict)."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: np.asarray(v, np.float32)
            for k, v in flatten_params(flat_params).items()}
    np.savez(os.path.join(directory, "params.npz"), **flat)
    cfg = config_to_dict(config) if isinstance(config, Config) else config
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def load_port_checkpoint(directory: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Returns (flat flax-path params, config dict)."""
    params_path = os.path.join(directory, "params.npz")
    if not os.path.exists(params_path):
        raise FileNotFoundError(f"no port checkpoint (params.npz) under "
                                f"{directory}")
    with np.load(params_path) as z:
        params = {k: z[k] for k in z.files}
    with open(os.path.join(directory, "config.json")) as f:
        config = json.load(f)
    return params, config
