"""Weight carry-over between the JAX package's flax tree and the port.

A flax parameter tree is keyed by paths such as `encoder/stage0_w` or
`vertex_decoder/block0/self_attn/query/kernel`.  `params_from_flax` turns
it into the port's `state_dict`, one leaf into one entry:
- a Dense or DenseGeneral kernel becomes a torch weight (out, in) over
  its flattened input and output axes.  The input axes are the first one,
  or the (H, hd) head axes of an attention `out` and of the fused
  decoder's `cross_out`: a (D, H, hd) query kernel becomes (H*hd, D), an
  (H, hd, D) output kernel (D, H*hd), the fused decoder's (D, L, H, hd)
  `cross_k_all` kernel (L*H*hd, D);
- a DenseGeneral bias (H, hd) or (L, H, hd) is flattened;
- LayerNorm `scale` becomes `weight`;
- raw parameters (encoder stages, slot queries, the PairDense kernel,
  whose rows are split by meaning) keep their layout;
- under `vertex_decoder/blocks/` (the `decoder_scan` layout, flax
  `nn.scan`'s stacked tree) every leaf keeps its leading layer axis and
  the rules above apply behind it.

`state_dict_to_flax` is its inverse, so a state_dict trained by the port
is written as a port checkpoint (`save_port_checkpoint`) that
`serve.WireframePredictor` serves.  `flax_param_shapes` lists the JAX
package's tree for every model shape it builds: the query decoder
unrolled, with fused cross-attention K/V, scanned, or both, and the
MLP head; and the port's own PTv3 and PTv2 encoders (`model.encoder:
ptv3` or `ptv2`), whose backbone leaves keep their torch names and
layouts.

The port's checkpoint is a directory with `params.npz` (flax paths ->
float32 arrays) and `config.json` (`config_to_dict` layout).  Reading
the JAX package's orbax checkpoints needs jax, so that stays out of the
port: the repository's `export_port_checkpoint.py`, which runs where
jax runs, writes them in the port's checkpoint layout.
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
# DenseGeneral kernels whose input is the (H, hd) head axes.
_HEAD_INPUT = ("out", "cross_out")
# The scanned decoder's stacked leaves (`model.decoder_scan`).
SCANNED = "vertex_decoder/blocks/"
# BatchNorm running statistics (the ptv3 and ptv2 backbones): buffers,
# not params.
_STATISTICS = ("/running_mean", "/running_var")


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


def _stacked(path: str) -> int:
    """1 for a leaf of the scanned decoder (leading layer axis), else 0."""
    return int(path.startswith(SCANNED))


def _input_axes(parts) -> int:
    """How many leading (per-layer) axes of a kernel are its input: two
    for the (H, hd, D) output projections, one for every other kernel."""
    return 2 if parts[-2] in _HEAD_INPUT else 1


def _torch_entry(path: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    parts = path.split("/")
    leaf, module = parts[-1], ".".join(parts[:-1])
    if path in _RAW_KERNELS or leaf not in ("kernel", "bias", "scale"):
        return ".".join(parts), arr
    if leaf == "scale":
        return f"{module}.weight", arr
    lead = arr.shape[:_stacked(path)]
    if leaf == "bias":
        return f"{module}.bias", arr.reshape(lead + (-1,))
    n_in = len(lead) + _input_axes(parts)
    if arr.ndim <= n_in:
        raise ValueError(f"unexpected kernel {path} of shape {arr.shape}")
    fan_in = int(np.prod(arr.shape[len(lead):n_in]))
    return f"{module}.weight", np.swapaxes(
        arr.reshape(lead + (fan_in, -1)), -1, -2)


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
        if key not in state and path.endswith(_STATISTICS):
            continue          # a tree of parameters only (Adam's moments)
        if key not in state:
            raise KeyError(f"state_dict has no {key} (flax {path})")
        arr = state[key].detach().float().cpu().numpy()
        if arr.shape != ported.shape:
            raise ValueError(f"{key}: shape {arr.shape}, expected "
                             f"{ported.shape}")
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel" and path not in _RAW_KERNELS:
            arr = np.swapaxes(arr, -1, -2)
        out[path] = np.ascontiguousarray(arr.reshape(shape), np.float32)
    return out


def flax_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf of the flax `PointCloudToWireframe` tree for `cfg` with
    its shape: the query head in any of its layouts
    (`decoder_fused_cross_kv`, `decoder_scan`, both, neither), or the
    parity MLP head."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def dense(path, i, o, into=shapes):
        into[f"{path}/kernel"] = (i, o)
        into[f"{path}/bias"] = (o,)

    def norm(path, d, into=shapes):
        into[f"{path}/scale"] = (d,)
        into[f"{path}/bias"] = (d,)

    def attention(path, d, heads, into=shapes):
        for name in ("query", "key", "value"):
            into[f"{path}/{name}/kernel"] = (d, heads, d // heads)
            into[f"{path}/{name}/bias"] = (heads, d // heads)
        into[f"{path}/out/kernel"] = (heads, d // heads, d)
        into[f"{path}/out/bias"] = (d,)

    prev, c = cfg.input_dim, cfg.encoder_output_dim
    if cfg.encoder != "pointnet":
        # A port-only tree: the backbone's state_dict (BatchNorm running
        # statistics included) under its own names, `/` for `.`.
        from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe

        with torch.device("meta"):
            backbone = PointCloudToWireframe(cfg).encoder.backbone
        for k, v in backbone.state_dict().items():
            shapes["encoder/backbone/" + k.replace(".", "/")] = tuple(v.shape)
        prev = backbone.out_channels
    for i, h in enumerate(() if cfg.encoder != "pointnet"
                          else cfg.encoder_hidden_dims):
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
    query = cfg.vertex_head == "query"
    if query:
        dense("vertex_decoder/point_proj", c, d)
        norm("vertex_decoder/point_ln", d)
        shapes["vertex_decoder/slot_queries"] = (v, d)
        dense("vertex_decoder/global_proj", c, d)
        layers, heads = cfg.decoder_layers, cfg.decoder_heads
        hd = d // heads
        if cfg.decoder_fused_cross_kv:
            for name in ("cross_k_all", "cross_v_all"):
                shapes[f"vertex_decoder/{name}/kernel"] = (d, layers, heads,
                                                           hd)
                shapes[f"vertex_decoder/{name}/bias"] = (layers, heads, hd)
        blk: Dict[str, Tuple[int, ...]] = {}
        norm("ln_self", d, blk)
        attention("self_attn", d, heads, blk)
        norm("ln_cross", d, blk)
        if cfg.decoder_fused_cross_kv:
            blk["cross_q/kernel"] = (d, heads, hd)
            blk["cross_q/bias"] = (heads, hd)
            blk["cross_out/kernel"] = (heads, hd, d)
            blk["cross_out/bias"] = (d,)
        else:
            attention("cross_attn", d, heads, blk)
        norm("ln_ffn", d, blk)
        dense("ffn_in", d, cfg.decoder_ffn_dim, blk)
        dense("ffn_out", cfg.decoder_ffn_dim, d, blk)
        if cfg.decoder_scan:          # nn.scan stacks each leaf by layer
            for name, shape in blk.items():
                shapes[f"{SCANNED}block/{name}"] = (layers,) + shape
        for i in range(0 if cfg.decoder_scan else layers):
            for name, shape in blk.items():
                shapes[f"vertex_decoder/block{i}/{name}"] = shape
        norm("vertex_decoder/out_ln", d)
        dense("vertex_decoder/coord_head", d, 3)
        dense("vertex_decoder/exist_head", d, 1)
    else:
        # models/vertex_head.py: widths 4096/2048/2048/1024 are fixed.
        vp = "vertex_predictor"
        dense(f"{vp}/point_pool_proj", 2 * c, c)
        for name, i, o in (("mlp1", c, 4096), ("mlp2", 4096, 2048),
                           ("mlp3", 2048, 2048), ("mlp4", 2048, 1024)):
            dense(f"{vp}/{name}/Dense_0", i, o)
            norm(f"{vp}/{name}/LayerNorm_0", o)
        dense(f"{vp}/residual_proj1", c, 2048)
        dense(f"{vp}/residual_proj2", c, 1024)
        dense(f"{vp}/final_layer", 1024, v * cfg.vertex_dim)

    h = cfg.edge_hidden_dim
    e = "edge_predictor"
    slot_dim = d if query and cfg.edge_use_slot_features else 0
    dense(f"{e}/Dense_0", 3 + slot_dim, h // 2)
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


def stack_layers(flat: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """An unrolled decoder's flat flax params (`vertex_decoder/block{i}/...`)
    in the scanned layout (`vertex_decoder/blocks/block/...`, each leaf
    stacked by layer): the same model under `decoder_scan`."""
    out = {k: v for k, v in flat.items()
           if not k.startswith("vertex_decoder/block")}
    for k in flat:
        if k.startswith("vertex_decoder/block0/"):
            name = k[len("vertex_decoder/block0/"):]
            out[f"{SCANNED}block/{name}"] = np.stack(
                [flat[f"vertex_decoder/block{i}/{name}"]
                 for i in range(num_layers)])
    return out


def init_flax_params(cfg: ModelConfig, seed: int) -> Dict[str, np.ndarray]:
    """Random flax-layout params at flax's init scales, from a numpy seed:
    lecun-normal kernels (truncated normal, fan-in over the input axes as
    flax's Dense and DenseGeneral take it, per layer for the scanned
    decoder, whose layers `nn.scan` initializes one by one), zero biases,
    unit LayerNorm scales, normal(0.02) slot queries."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in flax_param_shapes(cfg).items():
        parts = path.split("/")
        leaf = parts[-1]
        if path.startswith("encoder/backbone/"):
            # torch layouts: a (out, in) weight, norm scales and running
            # variances at 1, everything else 0.
            arr = np.zeros(shape)
            if leaf == "weight" and len(shape) == 2:
                arr = rng.standard_normal(shape) / np.sqrt(shape[1])
            elif leaf in ("weight", "running_var"):
                arr = np.ones(shape)
        elif leaf == "kernel" or leaf.endswith("_w"):
            per_layer = shape[_stacked(path):]
            fan_in = int(np.prod(per_layer[:_input_axes(parts)]))
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
