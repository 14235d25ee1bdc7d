"""Plain PyTorch reference of the wireframe model with Point Transformer V3
(Wu et al., CVPR 2024, arXiv:2312.10035; Pointcept's
`point_transformer_v3m1_base.py`) as its point backbone, written from
the architecture's description and nothing of the program.

One cloud at a time, with data-dependent shapes:
- the cloud's valid rows (|sum of features| > 1e-9); grid coordinates
  floor((xyz - the cloud's min) / grid_size) in float32; grid sampling
  keeps, of each occupied voxel, the first row in row order;
- serialization: per curve ("z", "z-trans", "hilbert", "hilbert-trans")
  the code of each voxel at depth d, the bit length of the batch's
  largest grid coordinate (as Pointcept measures it, over the batch):
  Morton bit by bit, x the most significant of each level; Hilbert as
  Pointcept's `hilbert.py` (the bits of each coordinate, most significant
  first, through Skilling's exchange-and-invert loop, then Gray to
  binary over the interleaved string); "-trans" swaps x and y first;
- stem: SubMConv3d(in, C0, k=5, no bias), BatchNorm, GELU;
- encoder stages (SerializedPooling from the second: clusters of equal
  code[0] >> 3, the cluster max of Linear(in, out), BatchNorm, GELU, the
  codes shifted right by 3, grid >> 1), decoder stages
  (SerializedUnpooling: BN-GELU(Linear(coarse))[cluster] +
  BN-GELU(Linear(skip)));
- blocks: x += LN(Linear(SubMConv3d_k3(x))); x += Attn(LN(x));
  x += MLP(LN(x)) with GELU; Attn in the serialized order of curve
  i % 4 for block i, patches of `ptv3_patch_size` rows with
  `get_padding_and_inverse`'s padding (a cloud above the patch size
  padded to a multiple of it by the rows one patch earlier; a cloud at
  or below it one segment of its own length), head dim scale
  1 / sqrt(head dim), padding rows' outputs dropped;
- the submanifold convolutions look neighbours up in a dense table of
  the cloud's voxels, offsets (dx, dy, dz) lexicographic, dz fastest,
  each offset's input channels side by side in the weight (out,
  k^3 * in);
- BatchNorm with its running statistics (eps 1e-3), LayerNorm eps 1e-5
  over float32, exact GELU.

Then the recipe: the backbone's features projected to
`encoder_output_dim` at every kept row (the rows grid sampling drops and
the padding rows are masked), the masked mean and the window max over
`decoder_kv_pool` consecutive rows, the fusion MLP, the query head and
the edge head of `reference/model.py`, imported.

Departures from Pointcept, each deliberate:
- products take bf16 operands (the configuration's compute dtype)
  where Pointcept's flash path casts to fp16; float32 accumulation;
- 8 input channels (xyz, rgba / 256, intensity / 2^16), not 6;
- inference only: no shuffle of the curves and no drop path;
- the cluster mean of the coordinates is not kept (without relative
  positional encoding nothing reads it).

`skip_cpe` names blocks ("enc0.0": encoder stage 0, block 0) whose xCPE
branch is left out: a planted fault for the limits of the comparison.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

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
    valid_rows,
)

BN_EPS, PTV3_LN_EPS = 1e-3, 1e-5
BB = "encoder.backbone."
# Pointcept's `PointTransformerV3` defaults, which its ScanNet base config
# keeps: the curves in block order, stride 2 at every pooling (one bit of
# each grid axis), the MLP's hidden width over C.
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
POOL_SHIFT, MLP_RATIO = 1, 4


def _ln(x, w, b):
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + PTV3_LN_EPS) * w + b


def _bn(P, name, x):
    x = x.float()
    return ((x - P[name + ".running_mean"])
            * torch.rsqrt(P[name + ".running_var"] + BN_EPS)
            * P[name + ".weight"] + P[name + ".bias"])


def _gelu(x):
    return torch.nn.functional.gelu(x.float())


def _lin(p: Precision, P, name, x):
    w = P[name + ".weight"]
    b = P.get(name + ".bias")
    if b is None:
        return mm(p, x, w.t())
    return dense(p, x, w, b)


# --- serialization ---------------------------------------------------------

def morton(grid: torch.Tensor, depth: int) -> torch.Tensor:
    code = torch.zeros_like(grid[:, 0])
    for level in range(depth):
        for axis, at in ((0, 2), (1, 1), (2, 0)):
            code |= ((grid[:, axis] >> level) & 1) << (3 * level + at)
    return code


def hilbert(grid: torch.Tensor, depth: int) -> torch.Tensor:
    """Pointcept's `hilbert.encode(grid, num_dims=3, num_bits=depth)`."""
    n = grid.shape[0]
    shifts = torch.arange(depth - 1, -1, -1, device=grid.device)
    gray = ((grid[:, :, None] >> shifts) & 1).bool()       # (n, 3, depth)
    for bit in range(depth):
        for dim in range(3):
            mask = gray[:, dim, bit]
            lower = slice(bit + 1, None)
            gray[:, 0, lower] ^= mask[:, None]
            to_flip = (~mask[:, None]) & (gray[:, 0, lower]
                                         ^ gray[:, dim, lower])
            gray[:, dim, lower] ^= to_flip
            gray[:, 0, lower] ^= to_flip
    bits = gray.transpose(1, 2).reshape(n, 3 * depth)      # interleaved
    binary = torch.cumsum(bits.long(), 1) % 2              # Gray -> binary
    weights = 2 ** torch.arange(3 * depth - 1, -1, -1, device=grid.device)
    return (binary * weights).sum(1)


def encode(grid: torch.Tensor, order: str, depth: int) -> torch.Tensor:
    if order.endswith("-trans"):
        grid = grid[:, [1, 0, 2]]
    if order.startswith("z"):
        return morton(grid, depth)
    return hilbert(grid, depth)


def grid_sample(x: torch.Tensor, grid_size: float):
    """(kept row indices, grid (n, 3) int64) of one cloud x (N, C): the
    first row in row order of each occupied voxel."""
    rows = torch.nonzero(valid_rows(x)).squeeze(1)
    xyz = x[rows, :3].float()
    grid = torch.floor((xyz - xyz.amin(0)) / grid_size).long()
    key = (grid[:, 0] << 32) | (grid[:, 1] << 16) | grid[:, 2]
    _, inverse = torch.unique(key, return_inverse=True)
    first = torch.full((int(inverse.max()) + 1,), len(key),
                       device=x.device).scatter_reduce(
        0, inverse, torch.arange(len(key), device=x.device), "amin")
    keep = torch.sort(first).values
    return rows[keep], grid[keep]


# --- layers ------------------------------------------------------------------

def neighbours(grid: torch.Tensor, size: int) -> torch.Tensor:
    """(n, size^3): the row of the voxel at each offset, n where none."""
    r = size // 2
    n = grid.shape[0]
    ext = grid.amax(0) + 2 * r + 1
    table = torch.full(tuple(ext.tolist()), n, dtype=torch.long,
                       device=grid.device)
    g = grid + r
    table[g[:, 0], g[:, 1], g[:, 2]] = torch.arange(n, device=grid.device)
    out = []
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dz in range(-r, r + 1):
                out.append(table[g[:, 0] + dx, g[:, 1] + dy, g[:, 2] + dz])
    return torch.stack(out, 1)


def subm_conv(p: Precision, P, name, x, nbr):
    n, c = x.shape
    xe = torch.cat([x.float(), x.new_zeros((1, c), dtype=torch.float32)])
    g = xe[nbr].reshape(n, -1)
    return _lin(p, P, name, g)


def patch_attention(p: Precision, qkv, order, heads: int, patch: int):
    """Attention of one cloud's rows (qkv (n, 3C)) in `order`."""
    dt = p.dtype
    n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    if n > patch:
        length = -(-n // patch) * patch
        pos = torch.arange(length, device=qkv.device)
        pos = torch.where(pos < n, pos, pos - patch)
        seg = patch
    else:
        pos = torch.arange(n, device=qkv.device)
        length, seg = n, n
    t = qkv[order[pos]].reshape(length // seg, seg, 3, heads, hd)
    q, k, v = (t[:, :, i].transpose(1, 2) for i in range(3))  # (S,H,L,hd)
    logits = mm(p, q, k.transpose(-1, -2), out_f32=True) * hd ** -0.5
    w = torch.softmax(logits, -1).to(dt)
    out = mm(p, w, v).transpose(1, 2).reshape(length, c)[:n]
    res = torch.empty_like(out)
    res[order] = out
    return res


def block(p: Precision, P, m: Dict, name: str, x, nbr, codes, index: int,
          heads: int, skip_cpe: Sequence[str], tag: str):
    if tag not in skip_cpe:
        h = subm_conv(p, P, name + "cpe_conv", x, nbr)
        h = _lin(p, P, name + "cpe_fc", h)
        x = x + _ln(h, P[name + "ln_cpe.weight"], P[name + "ln_cpe.bias"])
    h = _ln(x, P[name + "ln_attn.weight"], P[name + "ln_attn.bias"])
    qkv = _lin(p, P, name + "qkv", h)
    order = torch.argsort(codes[index % codes.shape[0]])
    h = patch_attention(p, qkv, order, heads, m["ptv3_patch_size"])
    x = x + _lin(p, P, name + "proj", h).float()
    h = _ln(x, P[name + "ln_mlp.weight"], P[name + "ln_mlp.bias"])
    h = _lin(p, P, name + "fc2", _gelu(_lin(p, P, name + "fc1", h)))
    return x + h.float()


def cloud_backbone(p: Precision, P, m: Dict, feat, grid, codes,
                   skip_cpe: Sequence[str] = ()):
    """The backbone on one cloud's grid-sampled rows: (n, C_out) f32."""
    enc_d, dec_d = m["ptv3_enc_depths"], m["ptv3_dec_depths"]
    x = _gelu(_bn(P, BB + "stem_bn",
                  subm_conv(p, P, BB + "stem_conv", feat,
                            neighbours(grid, 5))))
    levels, skips = [], []
    for s in range(len(enc_d)):
        name = f"{BB}enc.{s}."
        if s:
            shift = POOL_SHIFT
            cluster_code = codes[0] >> (3 * shift)
            uniq, cluster = torch.unique(cluster_code, return_inverse=True)
            h = _lin(p, P, name + "pool.proj", x)
            pooled = h.new_zeros((len(uniq), h.shape[1])).scatter_reduce(
                0, cluster[:, None].expand(-1, h.shape[1]), h, "amax",
                include_self=False)
            head = torch.full((len(uniq),), len(cluster),
                              device=x.device).scatter_reduce(
                0, cluster, torch.arange(len(cluster), device=x.device),
                "amin")
            levels[-1]["cluster"] = cluster
            x = _gelu(_bn(P, name + "pool.bn", pooled))
            grid = grid[head] >> shift
            codes = codes[:, head] >> (3 * shift)
        nbr = neighbours(grid, 3)
        levels.append({"nbr": nbr, "codes": codes})
        for i in range(enc_d[s]):
            x = block(p, P, m, f"{name}blocks.{i}.", x, nbr, codes, i,
                      m["ptv3_enc_num_head"][s], skip_cpe, f"enc{s}.{i}")
        skips.append(x)
    for s in range(len(dec_d) - 1, -1, -1):
        name = f"{BB}dec.{s}."
        lv = levels[s]
        up = _gelu(_bn(P, name + "pool.bn", _lin(p, P, name + "pool.proj",
                                                 x)))
        x = _gelu(_bn(P, name + "pool.bn_skip",
                      _lin(p, P, name + "pool.proj_skip", skips[s])))
        x = x + up[lv["cluster"]]
        for i in range(dec_d[s]):
            x = block(p, P, m, f"{name}blocks.{i}.", x, lv["nbr"],
                      lv["codes"], i, m["ptv3_dec_num_head"][s], skip_cpe,
                      f"dec{s}.{i}")
    return x


def encoder(p: Precision, P: Dict, m: Dict, x: torch.Tensor,
            skip_cpe: Sequence[str] = ()):
    """(global features (B, C) f32, pools) of clouds x (B, N, C_in)."""
    b, n, _ = x.shape
    sampled = [grid_sample(x[i], m["ptv3_grid_size"]) for i in range(b)]
    top = max(int(g.max()) if len(g) else 0 for _, g in sampled)
    depth = max(top, 1).bit_length()
    w = m["decoder_kv_pool"] if m["vertex_head"] == "query" else 1
    means, maxes, kvs, kv_masks = [], [], [], []
    for i, (rows, grid) in enumerate(sampled):
        codes = torch.stack([encode(grid, o, depth) for o in ORDERS])
        feats = cloud_backbone(p, P, m, x[i, rows].float(), grid, codes,
                               skip_cpe)
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
            win = torch.where(km[:, None], win, torch.zeros_like(win))
            kvs.append(win)
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
            skip_cpe: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """The inference forward on clouds x (B, N, 8); m: the configuration's
    `model` section (query head, existence slot mask)."""
    if m["vertex_head"] != "query" or m["slot_mask_mode"] != "existence":
        raise ValueError("the PTv3 reference runs the recipe's query head "
                         "with existence slot masks")
    g, pools = encoder(p, P, m, x, skip_cpe)
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


def counts_of(m: Dict, x: torch.Tensor) -> List[Dict[str, int]]:
    """Per cloud of x: the rows of each stage and the neighbour pairs of
    each stage's k=3 map and of the stem's k=5 map, from the clouds'
    own grid coordinates (what the benchmark's operation counts take)."""
    out = []
    for i in range(x.shape[0]):
        _, grid = grid_sample(x[i], m["ptv3_grid_size"])
        rec = {"rows": [], "pairs3": [], "pairs5": 0}
        rec["pairs5"] = int((neighbours(grid, 5) < len(grid)).sum())
        for s in range(len(m["ptv3_enc_depths"])):
            if s:
                grid = torch.unique(grid >> POOL_SHIFT, dim=0)
            rec["rows"].append(len(grid))
            rec["pairs3"].append(int((neighbours(grid, 3) < len(grid)).sum()))
        out.append(rec)
    return out
