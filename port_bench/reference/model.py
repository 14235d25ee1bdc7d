"""Plain PyTorch reference of the wireframe model, written from the
architecture's description and nothing of the program.

The forward is a function of a dict of parameters, keyed by the names
under which the benchmark hands the same seeded weights to the program
(its `state_dict` names; shapes as torch stores them: a dense weight is
(out, in), the point MLP's `stage{i}_w` and `proj_w` are (in, out), the
pair layer's `kernel` is (in, out)).

Architecture:
- point MLP 8 -> 512 -> 1024 -> 2048 -> 1024 -> 512 (Linear, LayerNorm,
  ReLU per stage; a plain Linear projection), masked over all-zero
  padding rows; masked mean and max pools; a fusion MLP 1024 -> 2048 ->
  1024 -> 512 over (max, mean);
- vertex head "query": the point features max-pooled over windows of
  `decoder_kv_pool` consecutive (z-sorted) rows, projected and
  normalised, and `max_vertices` learned slot queries (plus the
  projected global feature) through pre-LN decoder blocks (self-attention,
  cross-attention to the windows, GELU FFN); per slot 3 coordinates and
  an existence logit;
- vertex head "mlp": 512 -> 4096 -> 2048 -> 2048 -> 1024 -> V x 4 over
  the global feature plus a projection of the masked pools, with two
  projected residuals;
- edge head: per-slot embedding (coordinates, and slot features with
  `edge_use_slot_features`), one self-attention layer with a residual,
  then per pair (i < j) [f_i, f_j, x_i, x_j, |x_i - x_j|] through an MLP
  1031 -> 512 -> 256 -> 128 -> 1 and a sigmoid.

Precision (`Precision`): every product takes its operands in the
configuration's compute dtype and accumulates in float32; a dense layer
returns the compute dtype (the point MLP's stages keep float32 through
their LayerNorm); LayerNorm and softmax statistics are float32.  The
control precisions round each product's operands lower: "fp8" to
float8 e4m3 with one scale per tensor, "tf32" runs float32 products on
TF32 tensor cores.

Dropout draws come from the caller's generator in the order the
architecture applies dropout, so a training step can be followed from
the same generator state.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
CHUNK_POINTS = 1 << 17
FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype            # the configuration's compute dtype
    lower: str = ""               # "", "fp8" or "tf32": the control

    @contextlib.contextmanager
    def matmul_mode(self):
        """TF32 products only for the "tf32" control."""
        cuda = torch.backends.cuda.matmul
        old = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
        cuda.allow_tf32 = self.lower == "tf32"
        torch.backends.cudnn.allow_tf32 = self.lower == "tf32"
        try:
            yield
        finally:
            cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand in the compute dtype (rounded through fp8
        with one scale per tensor for the "fp8" control)."""
        t = t.to(self.dtype)
        if self.lower != "fp8":
            return t
        amax = torch.clamp_min(t.detach().abs().amax().float(), 1e-30)
        scale = FP8_MAX / amax
        q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
        # Straight-through: the rounding has the gradient of identity.
        return (t.float() + (q - t.float()).detach()).to(self.dtype)


def mm(p: Precision, a: torch.Tensor, b: torch.Tensor,
       out_f32: bool = False) -> torch.Tensor:
    """a @ b with operands in the compute dtype.  out_f32: the float32
    sums, not rounded to the compute dtype."""
    a, b = p.operand(a), p.operand(b)
    if out_f32:
        return torch.matmul(a.float(), b.float())
    return torch.matmul(a, b)


def dense(p: Precision, x, w, bias):
    """x @ w.T + bias in the compute dtype (w: (out, in))."""
    return mm(p, x, w.t()) + bias.to(p.dtype)


def layer_norm(x, scale, bias):
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def dropout(x, rate: float, train: bool, gen):
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def valid_rows(x):
    return torch.abs(x.sum(-1)) > 1e-9


def masked_mean(f, m):
    mf = m[..., None].to(f.dtype)
    return (f * mf).sum(-2) / torch.clamp_min(mf.sum(-2), 1.0)


def masked_max(f, m):
    out = torch.where(m[..., None], f, torch.full_like(f, -torch.inf)).amax(-2)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def attention(p: Precision, P: Dict, pre: str, xq, xkv, heads: int,
              key_mask=None, rate: float = 0.0, train: bool = False,
              gen=None):
    """Multi-head attention: q/k/v/out dense layers; the query divided by
    sqrt(head dim) in the compute dtype; masked keys get the dtype's
    lowest value; softmax over keys; dropout on the weights with one
    (Q, K) mask for the whole batch and every head."""
    dt = p.dtype
    q = dense(p, xq, P[pre + "query.weight"], P[pre + "query.bias"])
    k = dense(p, xkv, P[pre + "key.weight"], P[pre + "key.bias"])
    v = dense(p, xkv, P[pre + "value.weight"], P[pre + "value.bias"])
    b, nq, d = q.shape
    hd = d // heads
    q = q.reshape(b, nq, heads, hd).transpose(1, 2)
    k = k.reshape(b, -1, heads, hd).transpose(1, 2)
    v = v.reshape(b, -1, heads, hd).transpose(1, 2)
    q = q / float(torch.tensor(math.sqrt(hd)).to(dt))
    logits = mm(p, q, k.transpose(-1, -2))                  # (B, H, Q, K)
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits,
                             torch.full_like(logits, torch.finfo(dt).min))
    w = torch.softmax(logits.float(), dim=-1).to(dt)
    if train and rate > 0.0:
        keep = torch.rand((1, 1) + w.shape[-2:], generator=gen,
                          device=w.device) < 1.0 - rate
        w = w * (keep.to(dt) / float(torch.tensor(1.0 - rate).to(dt)))
    ctx = mm(p, w, v).transpose(1, 2).reshape(b, nq, d)
    return dense(p, ctx, P[pre + "out.weight"], P[pre + "out.bias"])


def point_pools(p: Precision, P: Dict, m: Dict, x: torch.Tensor):
    """(masked mean, masked max, kv tokens, kv mask) of clouds x: the
    point MLP, then the pools (over windows of `decoder_kv_pool` rows for
    the query head)."""
    mask = valid_rows(x)
    h = x.float()
    for i in range(len(m["encoder_hidden_dims"])):
        e = f"encoder.stage{i}_"
        z = mm(p, h, P[e + "w"], out_f32=True) + P[e + "b"]
        h = torch.relu(layer_norm(z, P[e + "ln_scale"], P[e + "ln_bias"]))
        h = h.to(p.dtype)
    feats = mm(p, h, P["encoder.proj_w"], out_f32=True) + P["encoder.proj_b"]
    mean = masked_mean(feats, mask)
    w = m["decoder_kv_pool"] if m["vertex_head"] == "query" else 1
    if w <= 1:
        return mean, masked_max(feats, mask), feats, mask
    b, n, c = feats.shape
    wm = mask.reshape(b, n // w, w)
    win = torch.where(wm[..., None], feats.reshape(b, n // w, w, c),
                      torch.full_like(feats.reshape(b, n // w, w, c),
                                      -torch.inf)).amax(2)
    kv_mask = wm.any(-1)
    win = torch.where(kv_mask[..., None], win, torch.zeros_like(win))
    return mean, masked_max(win, kv_mask), win, kv_mask


def encoder(p: Precision, P: Dict, m: Dict, x: torch.Tensor):
    """(global features (B, C) f32, pools dict) of clouds x (B, N, 8).

    The point MLP runs on blocks of clouds of at most CHUNK_POINTS rows;
    under autograd each block is recomputed in the backward
    (`torch.utils.checkpoint`), so a large batch fits beside nothing
    else of the program."""
    per = max(1, CHUNK_POINTS // x.shape[1])
    parts = []
    for s in range(0, x.shape[0], per):
        if torch.is_grad_enabled():
            parts.append(checkpoint(point_pools, p, P, m, x[s:s + per],
                                    use_reentrant=False))
        else:
            parts.append(point_pools(p, P, m, x[s:s + per]))
    mean, mx, kv, kv_mask = (torch.cat(t) for t in zip(*parts))
    pools = {"masked_mean": mean, "masked_max": mx, "kv": kv,
             "kv_mask": kv_mask}
    g = torch.cat([pools["masked_max"], pools["masked_mean"]], -1)
    f = "encoder.fusion."
    g = torch.relu(layer_norm(dense(p, g, P[f + "Dense_0.weight"],
                                    P[f + "Dense_0.bias"]),
                              P[f + "LayerNorm_0.weight"],
                              P[f + "LayerNorm_0.bias"]))
    g = torch.relu(layer_norm(dense(p, g, P[f + "Dense_1.weight"],
                                    P[f + "Dense_1.bias"]),
                              P[f + "LayerNorm_1.weight"],
                              P[f + "LayerNorm_1.bias"]))
    g = dense(p, g, P[f + "Dense_2.weight"], P[f + "Dense_2.bias"]).float()
    return g, pools


def _ln(P, pre, x):
    return layer_norm(x, P[pre + ".weight"], P[pre + ".bias"])


def query_head(p: Precision, P: Dict, m: Dict, g, pools, train, gen):
    dt = p.dtype
    d = "vertex_decoder."
    kv = _ln(P, d + "point_ln", dense(p, pools["kv"], P[d + "point_proj.weight"],
                                      P[d + "point_proj.bias"]))
    b = g.shape[0]
    q = P[d + "slot_queries"].to(dt)[None].expand(b, -1, -1)
    q = q + dense(p, g, P[d + "global_proj.weight"],
                  P[d + "global_proj.bias"])[:, None, :]
    rate = m["decoder_dropout"]
    for i in range(m["decoder_layers"]):
        blk = f"{d}block{i}."
        h = _ln(P, blk + "ln_self", q)
        q = q + attention(p, P, blk + "self_attn.", h, h, m["decoder_heads"],
                          rate=rate, train=train, gen=gen)
        h = _ln(P, blk + "ln_cross", q)
        q = q + attention(p, P, blk + "cross_attn.", h, kv,
                          m["decoder_heads"], key_mask=pools["kv_mask"],
                          rate=rate, train=train, gen=gen)
        h = gelu(dense(p, _ln(P, blk + "ln_ffn", q), P[blk + "ffn_in.weight"],
                       P[blk + "ffn_in.bias"]))
        h = dropout(h, rate, train, gen)
        q = q + dense(p, h, P[blk + "ffn_out.weight"], P[blk + "ffn_out.bias"])
    feats = _ln(P, d + "out_ln", q)
    coords = dense(p, feats, P[d + "coord_head.weight"],
                   P[d + "coord_head.bias"]).float()
    logits = dense(p, feats, P[d + "exist_head.weight"],
                   P[d + "exist_head.bias"])[..., 0].float()
    return coords, logits, feats.float()


def mlp_head(p: Precision, P: Dict, m: Dict, g, pools):
    v = "vertex_predictor."

    def block(name, x):
        return torch.relu(_ln(P, v + name + ".LayerNorm_0",
                              dense(p, x, P[v + name + ".Dense_0.weight"],
                                    P[v + name + ".Dense_0.bias"])))

    pooled = torch.cat([pools["masked_mean"], pools["masked_max"]], -1)
    e = g.to(p.dtype) + dense(p, pooled, P[v + "point_pool_proj.weight"],
                              P[v + "point_pool_proj.bias"])
    x = block("mlp2", block("mlp1", e))
    x = block("mlp3", x) + dense(p, e, P[v + "residual_proj1.weight"],
                                 P[v + "residual_proj1.bias"])
    x = block("mlp4", x) + dense(p, e, P[v + "residual_proj2.weight"],
                                 P[v + "residual_proj2.bias"])
    out = dense(p, x, P[v + "final_layer.weight"],
                P[v + "final_layer.bias"]).float()
    out = out.reshape(out.shape[0], m["max_vertices"], 4)
    return out[..., :3], out[..., 3]


def pair_index(v: int, device):
    i, j = torch.triu_indices(v, v, offset=1, device=device)
    return i, j


def edge_head(p: Precision, P: Dict, m: Dict, verts, slot_mask,
              attn_mask, slot_feats, train, gen):
    """(edge logits (B, E) f32, pair mask (B, E)) over all slot pairs."""
    dt = p.dtype
    e = "edge_predictor."
    rate_a, rate_m = m["attn_dropout"], m["edge_dropout"]
    x = verts.to(dt)
    inp = x if slot_feats is None else torch.cat([x, slot_feats.to(dt)], -1)
    f = _ln(P, e + "LayerNorm_0", dense(p, inp, P[e + "Dense_0.weight"],
                                        P[e + "Dense_0.bias"]))
    f = _ln(P, e + "LayerNorm_1", dense(p, gelu(f), P[e + "Dense_1.weight"],
                                        P[e + "Dense_1.bias"]))
    f = dropout(f, rate_m, train, gen)
    f = f + attention(p, P, e + "attention.", f, f, m["edge_num_heads"],
                      key_mask=attn_mask, rate=rate_a, train=train, gen=gen)
    i, j = pair_index(verts.shape[1], verts.device)
    dist = torch.sqrt(((x[:, i] - x[:, j]) ** 2).sum(-1, keepdim=True)
                      + 1e-12)
    k = P[e + "Dense_2.kernel"]
    h, c = f.shape[-1], x.shape[-1]
    u_i = mm(p, f, k[:h]) + mm(p, x, k[2 * h:2 * h + c])
    u_j = mm(p, f, k[h:2 * h]) + mm(p, x, k[2 * h + c:2 * h + 2 * c])
    y = (u_i[:, i] + u_j[:, j] + dist * k[2 * h + 2 * c].to(dt)
         + P[e + "Dense_2.bias"].to(dt))
    y = dropout(gelu(_ln(P, e + "LayerNorm_2", y)), rate_m, train, gen)
    y = gelu(_ln(P, e + "LayerNorm_3", dense(p, y, P[e + "Dense_3.weight"],
                                             P[e + "Dense_3.bias"])))
    y = dropout(y, rate_m, train, gen)
    y = gelu(dense(p, y, P[e + "Dense_4.weight"], P[e + "Dense_4.bias"]))
    logits = dense(p, y, P[e + "Dense_5.weight"],
                   P[e + "Dense_5.bias"])[..., 0].float()
    return logits, slot_mask[:, i] & slot_mask[:, j]


def forward(p: Precision, P: Dict, m: Dict, x: torch.Tensor,
            counts: Optional[torch.Tensor] = None, train: bool = False,
            gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The model on clouds x (B, N, 8).  m: the configuration's `model`
    section.  counts: the ground-truth vertex counts, which set the live
    slots in training under the "prefix" slot mask."""
    if m["vertex_head"] == "query" and m["decoder_kv_pool"] > 1 \
            and not m["points_z_sorted"]:
        raise ValueError("the query head's windows need z-sorted clouds")
    g, pools = encoder(p, P, m, x)
    slot_feats = None
    if m["vertex_head"] == "query":
        verts, logits, feats = query_head(p, P, m, g, pools, train, gen)
        if m["edge_use_slot_features"]:
            slot_feats = feats
    else:
        verts, logits = mlp_head(p, P, m, g, pools)
    probs = torch.sigmoid(logits)
    v = verts.shape[1]
    if m["slot_mask_mode"] == "existence":
        slot_mask = probs > 0.5
        attn_mask = torch.ones_like(slot_mask)
    else:
        live = counts if (train and counts is not None) \
            else (probs > 0.5).sum(-1)
        slot_mask = (torch.arange(v, device=x.device)[None]
                     < live[:, None])
        attn_mask = slot_mask
    edge_logits, pair_mask = edge_head(p, P, m, verts, slot_mask, attn_mask,
                                       slot_feats, train, gen)
    return {"vertices": verts, "existence_logits": logits,
            "existence_probabilities": probs, "edge_logits": edge_logits,
            "edge_probs": torch.sigmoid(edge_logits) * pair_mask.float(),
            "pair_mask": pair_mask}
