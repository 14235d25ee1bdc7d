"""Plain PyTorch reference of the wireframe model with Point Transformer V2
(Wu et al., NeurIPS 2022, arXiv:2210.05666; Pointcept's
`point_transformer_v2m2_base.py`, `PT-v2m2`) as its point backbone,
written from the architecture's description and nothing of the program.

One cloud at a time, with data-dependent shapes, every norm, activation
and sum in float32 (products as `reference/model.py`'s `Precision` takes
them: operands in the compute dtype, float32 accumulation; the caller
turns TF32 off through `Precision.matmul_mode`):
- the cloud's valid rows, grid sampling at `ptv2_grid_size` (the first
  row in row order of each occupied voxel: `reference/ptv3.py`'s
  `grid_sample`); the rows stay in row order;
- BN: (x - running mean) / sqrt(running var + 1e-5) * weight + bias;
- patch embed: ReLU(BN(Linear(in, C, no bias))), one block sequence;
- block sequence: the k nearest rows of each row among the cloud's rows
  (the row itself included) by the float32 squared distance
  (dx*dx + dy*dy) + dz*dz, d = xyz_j - xyz_i, sorted by (distance, row),
  -1 past the cloud's row count (pointops' `knn_query`);
- block: h = ReLU(BN1(fc1(x))); h = GVA(h); h = ReLU(BN2(h));
  h = BN3(fc3(h)); x = ReLU(x + h);
- GVA: q = ReLU(BN(Linear(x))), k = ReLU(BN(Linear(x))), v = Linear(x);
  for each neighbour slot, its key, value and relative position
  xyz_j - xyz_i (all zero for index -1, pointops' `grouping`);
  peb = Linear(ReLU(BN(Linear(3, C)(p)))); r = k_j - q_i + peb;
  v_j + peb; w = Linear(G, G)(ReLU(BN(Linear(C, G)(r)))); softmax over
  the slots per group, times sign(idx + 1); each group's C / G channels
  summed with its weight over the slots;
- grid pooling at `ptv2_grid_sizes[s]`: f = ReLU(BN(Linear(in, out, no
  bias))); cells floor((xyz - the cloud's least coordinate) / grid size)
  in float32; the coarse rows are the occupied cells in (x, y, z) order,
  each the max of its rows' f and the mean of their xyz;
- unpooling: ReLU(BN(Linear(coarse)))[cell] + ReLU(BN(Linear(skip))),
  then the decoder stage's block sequence at the skip's rows.

Then the recipe: the backbone's 48 channels projected to
`encoder_output_dim` at every kept row (the rows grid sampling drops and
the padding rows are masked), the masked mean and the window max over
`decoder_kv_pool` consecutive rows, the fusion MLP, the query head and
the edge head of `reference/model.py`, imported.

Departures from Pointcept, each deliberate:
- products take bf16 operands (the configuration's compute dtype) where
  Pointcept computes in float32; float32 accumulation;
- 8 input channels (xyz, rgba / 256, intensity / 2^16), not 6;
- grid sampling keeps each voxel's first row in row order, where
  Pointcept's `GridSample` (train mode) draws one at random;
- a cell's mean coordinate is summed in float64 and rounded once to
  float32, so its bits do not hang on the order of the sum;
- inference only: no drop path, no attention dropout.

`skip_peb` names blocks ("enc0.0": encoder stage 0, block 0; "embed.0",
"dec0.0") whose GVA leaves the positional bias out: a planted fault for
the limits of the comparison.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from port_bench.reference.model import (
    Precision,
    dense,
    edge_head,
    layer_norm,
    masked_max,
    masked_mean,
    mm,
    query_head,
)
from port_bench.reference.ptv3 import grid_sample

BN_EPS = 1e-5
BB = "encoder.backbone."


def _bn(P, name, x):
    x = x.float()
    return ((x - P[name + ".running_mean"])
            * torch.rsqrt(P[name + ".running_var"] + BN_EPS)
            * P[name + ".weight"] + P[name + ".bias"])


def _lin(p: Precision, P, name, x):
    w = P[name + ".weight"]
    b = P.get(name + ".bias")
    if b is None:
        return mm(p, x, w.t())
    return dense(p, x, w, b)


def _bn_relu(P, name, x):
    return torch.relu(_bn(P, name, x))


# --- neighbours and cells ----------------------------------------------------

def knn(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) int64: the k nearest rows of each row of one cloud's xyz
    (n, 3), sorted by (distance, row), -1 past n."""
    n = xyz.shape[0]
    d = xyz[None, :, :] - xyz[:, None, :]
    dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            + d[..., 2] * d[..., 2])
    idx = torch.sort(dist, dim=1, stable=True).indices[:, :k]
    out = torch.full((n, k), -1, dtype=torch.long, device=xyz.device)
    out[:, :idx.shape[1]] = idx
    return out


def grid_pool_cells(xyz: torch.Tensor, grid_size: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each row's cell index into the occupied cells in (x, y, z) order,
    the cells' mean coordinates (cells, 3) float32)."""
    cell = torch.floor((xyz - xyz.amin(0)) / grid_size).long()
    key = (cell[:, 0] << 32) | (cell[:, 1] << 16) | cell[:, 2]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float64,
                       device=xyz.device).index_add_(0, inv, xyz.double())
    n = torch.zeros(len(uniq), dtype=torch.float64,
                    device=xyz.device).index_add_(
        0, inv, torch.ones_like(inv, dtype=torch.float64))
    return inv, (sums / n[:, None]).float()


# --- layers ------------------------------------------------------------------

def gva(p: Precision, P, name: str, x, xyz, nbr, groups: int,
        peb_on: bool = True):
    n, c = x.shape
    k = nbr.shape[1]
    has = nbr >= 0
    j = nbr.clamp_min(0)
    q = _bn_relu(P, name + "q_bn", _lin(p, P, name + "q", x))
    key = _bn_relu(P, name + "k_bn", _lin(p, P, name + "k", x))
    val = _lin(p, P, name + "v", x).float()
    zero = torch.zeros((), device=x.device)
    kj = torch.where(has[..., None], key[j], zero)
    vj = torch.where(has[..., None], val[j], zero)
    pos = torch.where(has[..., None], xyz[j] - xyz[:, None], zero)
    peb = zero
    if peb_on:
        peb = _lin(p, P, name + "pe2",
                   _bn_relu(P, name + "pe_bn",
                            _lin(p, P, name + "pe1", pos))).float()
    rel = kj - q[:, None] + peb
    vv = vj + peb
    w = _lin(p, P, name + "we2",
             _bn_relu(P, name + "we_bn",
                      _lin(p, P, name + "we1", rel))).float()
    w = torch.softmax(w, dim=1) * has[..., None]
    out = (vv.reshape(n, k, groups, c // groups) * w[..., None]).sum(1)
    return out.reshape(n, c)


def block(p: Precision, P, name: str, x, xyz, nbr, groups: int,
          peb_on: bool):
    h = _bn_relu(P, name + "bn1", _lin(p, P, name + "fc1", x))
    h = gva(p, P, name + "attn.", h, xyz, nbr, groups, peb_on)
    h = _bn_relu(P, name + "bn2", h)
    h = _bn(P, name + "bn3", _lin(p, P, name + "fc3", h))
    return torch.relu(x + h)


def sequence(p: Precision, P, name: str, tag: str, x, xyz, depth: int,
             groups: int, k: int, skip_peb: Sequence[str]):
    nbr = knn(xyz, k)
    for i in range(depth):
        x = block(p, P, f"{name}blocks.{i}.", x, xyz, nbr, groups,
                  f"{tag}.{i}" not in skip_peb)
    return x


def cloud_backbone(p: Precision, P, m: Dict, feat, skip_peb=()):
    """The backbone on one cloud's grid-sampled rows feat (n, C_in), in
    row order: (n, C_out) float32."""
    xyz = feat[:, :3].float()
    x = _bn_relu(P, BB + "patch_embed.pool.bn",
                 _lin(p, P, BB + "patch_embed.pool.proj", feat))
    x = sequence(p, P, BB + "patch_embed.", "embed", x, xyz,
                 m["ptv2_patch_embed_depth"], m["ptv2_patch_embed_groups"],
                 m["ptv2_patch_embed_neighbours"], skip_peb)
    coords, cells, skips = [xyz], [], [x]
    for s in range(len(m["ptv2_enc_depths"])):
        name = f"{BB}enc.{s}."
        inv, xyz = grid_pool_cells(coords[-1], m["ptv2_grid_sizes"][s])
        f = _bn_relu(P, name + "pool.bn", _lin(p, P, name + "pool.proj", x))
        x = f.new_zeros((xyz.shape[0], f.shape[1])).scatter_reduce(
            0, inv[:, None].expand(-1, f.shape[1]), f, "amax",
            include_self=False)
        x = sequence(p, P, name, f"enc{s}", x, xyz, m["ptv2_enc_depths"][s],
                     m["ptv2_enc_groups"][s], m["ptv2_enc_neighbours"][s],
                     skip_peb)
        coords.append(xyz)
        cells.append(inv)
        skips.append(x)
    for s in range(len(m["ptv2_dec_depths"]) - 1, -1, -1):
        name = f"{BB}dec.{s}."
        up = _bn_relu(P, name + "pool.bn", _lin(p, P, name + "pool.proj", x))
        x = up[cells[s]] + _bn_relu(P, name + "pool.skip_bn",
                                    _lin(p, P, name + "pool.proj_skip",
                                         skips[s]))
        x = sequence(p, P, name, f"dec{s}", x, coords[s],
                     m["ptv2_dec_depths"][s], m["ptv2_dec_groups"][s],
                     m["ptv2_dec_neighbours"][s], skip_peb)
    return x


def encoder(p: Precision, P: Dict, m: Dict, x: torch.Tensor,
            skip_peb: Sequence[str] = ()):
    """(global features (B, C) f32, pools) of clouds x (B, N, C_in)."""
    b, n, _ = x.shape
    w = m["decoder_kv_pool"] if m["vertex_head"] == "query" else 1
    means, maxes, kvs, kv_masks = [], [], [], []
    for i in range(b):
        rows, _ = grid_sample(x[i], m["ptv2_grid_size"])
        feats = cloud_backbone(p, P, m, x[i, rows].float(), skip_peb)
        f = mm(p, feats, P["encoder.proj_w"]).float() + P["encoder.proj_b"]
        full = f.new_zeros((n, f.shape[1]))
        full[rows] = f
        kept = torch.zeros(n, dtype=torch.bool, device=x.device)
        kept[rows] = True
        means.append(masked_mean(full, kept))
        if w > 1:
            nw = -(-n // w)
            pad = nw * w - n
            fw = torch.nn.functional.pad(full, (0, 0, 0, pad))
            kw = torch.nn.functional.pad(kept, (0, pad)).reshape(nw, w)
            win = torch.where(kw[..., None], fw.reshape(nw, w, -1),
                              torch.full_like(fw.reshape(nw, w, -1),
                                              -torch.inf)).amax(1)
            km = kw.any(-1)
            kvs.append(torch.where(km[:, None], win, torch.zeros_like(win)))
            kv_masks.append(km)
        else:
            kvs.append(full)
            kv_masks.append(kept)
        maxes.append(masked_max(kvs[-1], kv_masks[-1]))
    pools = {"masked_mean": torch.stack(means),
             "masked_max": torch.stack(maxes), "kv": torch.stack(kvs),
             "kv_mask": torch.stack(kv_masks)}
    g = torch.cat([pools["masked_max"], pools["masked_mean"]], -1)
    f = "encoder.fusion."
    for i in range(2):
        g = torch.relu(layer_norm(dense(p, g, P[f"{f}Dense_{i}.weight"],
                                        P[f"{f}Dense_{i}.bias"]),
                                  P[f"{f}LayerNorm_{i}.weight"],
                                  P[f"{f}LayerNorm_{i}.bias"]))
    g = dense(p, g, P[f + "Dense_2.weight"], P[f + "Dense_2.bias"]).float()
    return g, pools


def forward(p: Precision, P: Dict, m: Dict, x: torch.Tensor,
            skip_peb: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """The inference forward on clouds x (B, N, 8); m: the configuration's
    `model` section (query head, existence slot mask)."""
    if m["vertex_head"] != "query" or m["slot_mask_mode"] != "existence":
        raise ValueError("the PTv2 reference runs the recipe's query head "
                         "with existence slot masks")
    g, pools = encoder(p, P, m, x, skip_peb)
    verts, logits, feats = query_head(p, P, m, g, pools, False, None)
    probs = torch.sigmoid(logits)
    slot_mask = probs > 0.5
    edge_logits, pair_mask = edge_head(
        p, P, m, verts, slot_mask, torch.ones_like(slot_mask),
        feats if m["edge_use_slot_features"] else None, False, None)
    return {"vertices": verts, "existence_logits": logits,
            "existence_probabilities": probs, "edge_logits": edge_logits,
            "edge_probs": torch.sigmoid(edge_logits) * pair_mask.float(),
            "pair_mask": pair_mask}


def counts_of(m: Dict, x: torch.Tensor) -> List[Dict[str, List[int]]]:
    """Per cloud of x: the rows of each level (the grid-sampled rows, then
    each encoder stage's cells), what the benchmark's operation counts
    take; a level of n rows has n * min(n, k) real neighbour slots."""
    out = []
    for i in range(x.shape[0]):
        rows, _ = grid_sample(x[i], m["ptv2_grid_size"])
        xyz = x[i, rows, :3].float()
        rec = [len(rows)]
        for gs in m["ptv2_grid_sizes"]:
            _, xyz = grid_pool_cells(xyz, gs)
            rec.append(xyz.shape[0])
        out.append({"rows": rec})
    return out
