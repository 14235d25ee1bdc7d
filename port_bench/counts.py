"""The yardstick's arithmetic: operations, bytes and the card's peaks.

Each count is of the function at the cell's shapes, whatever implements
it (1 multiply-add = 2 operations; LayerNorms, activations, pooling and
softmax not counted):
- the point MLP forward: 2 * sum(in_i * out_i) a point (10.49 MFLOP at
  the published widths 8 -> 512 -> 1024 -> 2048 -> 1024 -> 512);
- its backward: 2x the forward from a stash, 3x with no stash (the
  function recomputes what it does not keep);
- the model forward a cloud: the point MLP, the fusion MLP, the vertex
  head and the edge head, every dense layer and attention product;
- a training step: 3x the forward (no recomputation counted).
Bytes: each input read once and each output written once.

Peaks by `torch.cuda.get_device_name()`, NVIDIA's H100 data sheet, dense
(no sparsity): bf16 989.4 TFLOP/s; float32 configurations against dense
TF32, 494.7 TFLOP/s, the fastest tensor-core rate that takes float32
operands (3xTF32 runs three TF32 products, so a third of it is that
implementation's ceiling, printed beside it); HBM 3.35 TB/s.  A card
not in the table raises.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 494.7e12,
                              "hbm": 3.35e12},
}


def peaks(device_name: str) -> Dict[str, float]:
    if device_name not in PEAKS:
        raise KeyError(f"no peaks for card {device_name!r}; add its data "
                       "sheet figures to port_bench/counts.py")
    return PEAKS[device_name]


def compute_peak(device_name: str, dtype: str) -> float:
    return peaks(device_name)[dtype]


def point_widths(m: Dict) -> Sequence[int]:
    return [m["input_dim"], *m["encoder_hidden_dims"],
            m["encoder_output_dim"]]


def point_mlp_flops(m: Dict) -> float:
    """Forward operations of the point MLP, a point."""
    w = point_widths(m)
    return float(2 * sum(a * b for a, b in zip(w, w[1:])))


def chain_flops(m: Dict, points: int, backward: str = "") -> float:
    """The point MLP over `points` rows: forward, plus the backward
    ("stash": 2x, "remat": 3x)."""
    factor = 1 + {"": 0, "stash": 2, "remat": 3}[backward]
    return factor * point_mlp_flops(m) * points


def chain_bytes(m: Dict, batch: int, n: int, backward: str = "") -> float:
    """Inputs read once, outputs written once, 4-byte floats: the clouds
    and the MLP's parameters in; the point features (or, with the kv
    pool, the pooled windows and their sums) out; the backward takes the
    outputs' cotangents in and writes the parameters' gradients."""
    w = point_widths(m)
    params = sum(a * b + 3 * b for a, b in zip(w[1:-1], w[2:-1]))
    params += w[0] * w[1] + 3 * w[1] + w[-2] * w[-1] + w[-1]
    pool = m["decoder_kv_pool"] if m["vertex_head"] == "query" else 1
    out_rows = batch * (n // pool) * (2 if pool > 1 else 1)
    fwd = 4 * (batch * n * w[0] + params + out_rows * w[-1])
    if not backward:
        return float(fwd)
    return float(fwd + 4 * (out_rows * w[-1] + params))


def least_seconds(flops: float, nbytes: float, device_name: str,
                  dtype: str) -> float:
    p = peaks(device_name)
    return max(flops / p[dtype], nbytes / p["hbm"])


def forward_flops_per_cloud(m: Dict, n_points: int) -> float:
    """Matmul operations of the inference forward for one cloud of
    `n_points` rows (padding rows included: the card computes them)."""
    enc = point_mlp_flops(m) * n_points
    c = m["encoder_output_dim"]
    fusion = 2 * (2 * c * 4 * c + 4 * c * 2 * c + 2 * c * c)
    v = m["max_vertices"]
    if m["vertex_head"] == "query":
        d, ffn, heads = m["decoder_dim"], m["decoder_ffn_dim"], \
            m["decoder_layers"]
        nk = -(-n_points // max(1, m["decoder_kv_pool"]))
        head = 2 * nk * c * d + 2 * c * d                  # kv + global proj
        head += heads * (
            4 * 2 * v * d * d + 2 * 2 * v * v * d          # self-attention
            + 2 * v * d * d + 2 * 2 * nk * d * d           # cross q, k, v
            + 2 * v * d * d + 2 * 2 * v * nk * d           # cross out, QK, AV
            + 2 * 2 * v * d * ffn)                         # FFN
        head += 2 * v * d * 4                              # coords, existence
        slot = d if m["edge_use_slot_features"] else 0
    else:
        head = 2 * (2 * c * c + c * 4096 + 4096 * 2048 + c * 2048
                    + 2048 * 2048 + c * 1024 + 2048 * 1024 + 1024 * v * 4)
        slot = 0
    h = m["edge_hidden_dim"]
    e = v * (v - 1) // 2
    edge = (2 * v * (3 + slot) * (h // 2) + 2 * v * (h // 2) * h
            + 4 * 2 * v * h * h + 2 * 2 * v * v * h        # slot attention
            + 2 * 2 * v * (h + 3) * h                      # pair layer, by slot
            + 2 * e * (h * (h // 2) + (h // 2) * (h // 4) + h // 4))
    return float(enc + fusion + head + edge)


def train_flops_per_cloud(m: Dict, n_points: int) -> float:
    """A training step's operations a cloud: 3x the forward."""
    return 3.0 * forward_flops_per_cloud(m, n_points)
