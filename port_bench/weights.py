"""Seeded weights, made on the device in one draw.

The benchmark makes the weights and hands the same tensors to the
program (`load_state_dict`) and to the reference.  Names and shapes are
the program's parameter names; the values come from one normal draw of a
generator on the device, split by name: matrices at 1/sqrt(fan in),
`slot_queries` at 5 and the vertex heads' coordinate outputs at 0.3
of their fan-in scale (see `_scale`), LayerNorm scales 1 + 0.05 n and every other
vector (biases) 0.02 n, so no parameter starts at a value that hides a
term of its gradient.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _is_norm_scale(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("ln_scale"):
        return True
    module = name.rsplit(".", 2)[-2] if name.count(".") else ""
    return leaf == "weight" and ("LayerNorm" in module or module.startswith(
        "ln_") or module.endswith("_ln"))


def _scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(offset, scale) of the normal draw for one parameter."""
    if name.endswith("slot_queries"):
        # Not the 0.02 of a fresh model: slots that start alike predict
        # alike vertices and alike existence (all slots live, or none,
        # by seed), and the L1 matching of clustered predictions ties
        # (every assignment of a slot set costs the same), so a rounding
        # difference picks another pairing.
        return 0.0, 5.0
    if name.endswith("coord_head.weight"):
        # Initial vertices spread over the normalised building (std
        # ~0.3), not beyond it, where L1 costs tie as above.
        return 0.0, 0.3 * shape[1] ** -0.5
    if len(shape) >= 2:
        # torch dense weights are (out, in); the point MLP's `_w` and the
        # pair layer's `kernel` are (in, out).
        fan_in = shape[1] if name.endswith(".weight") else shape[0]
        return 0.0, fan_in ** -0.5
    if _is_norm_scale(name):
        return 1.0, 0.05
    return 0.0, 0.02


def _coordinate_rows(name: str, shape: Tuple[int, ...]):
    """The MLP head's last layer emits (x, y, z, existence) a slot: its
    coordinate rows are scaled as the query head's coordinate head."""
    if name.endswith("vertex_predictor.final_layer.weight"):
        return torch.arange(shape[0]) % 4 != 3
    return None


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        n = int(torch.Size(shape).numel())
        offset, scale = _scale(name, shape)
        w = flat[at:at + n].view(shape) * scale + offset
        rows = _coordinate_rows(name, shape)
        if rows is not None:
            w[rows.to(device)] *= 0.3
        out[name] = w.contiguous()
        at += n
    return out
