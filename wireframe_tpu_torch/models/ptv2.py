"""Point Transformer V2 backbone (Wu et al., NeurIPS 2022, arXiv:2210.05666),
as Pointcept's `point_transformer_v2m2_base.py` (`PT-v2m2`) builds it, on
a packed batch of fixed row capacities, at inference.

Layers (Pointcept's names in brackets; BN is BatchNorm1d over channels
with its running statistics, eps 1e-5):
- patch embed [GVAPatchEmbed]: ReLU(BN(Linear(in, C, no bias))), then a
  block sequence at `patch_embed_neighbours`;
- encoder stage s [Encoder]: grid pooling at `grid_sizes[s]`, then a
  block sequence; decoder stage s (from the deepest up) [Decoder]:
  unpooling onto stage s's skip, then a block sequence at the skip's
  rows;
- block sequence [BlockSequence]: the k nearest neighbours of every row
  within its cloud, the row itself included (`ops.knn`), shared by its
  blocks;
- block [Block]: h = ReLU(BN1(fc1(x))); h = GVA(h); h = ReLU(BN2(h));
  h = BN3(fc3(h)); x = ReLU(x + h); fc1, fc3 C -> C without bias;
- GVA [GroupedVectorAttention], row i and its neighbours j:
  q = ReLU(BN(Linear(x))), k = ReLU(BN(Linear(x))), v = Linear(x), all
  with bias; p_ij = xyz_j - xyz_i; peb = Linear(C, C)(ReLU(BN(Linear(3,
  C)(p_ij)))); r_ij = k_j - q_i + peb; v_ij = v_j + peb; w =
  Linear(G, G)(ReLU(BN(Linear(C, G)(r_ij)))), softmax over the
  neighbours per group, times the mask sign(idx + 1); out_i[g] =
  sum_j w_ij[g] v_ij[g], each group's C / G channels side by side;
- a missing neighbour (index -1, a cloud of fewer than k rows) follows
  pointops' `grouping`: its key, value and relative position are zero,
  it enters the softmax's denominator, and its weight is zeroed after;
- pooling [GridPool]: f = ReLU(BN(Linear(in, out, no bias))); the cell
  floor((xyz - the cloud's least coordinate) / grid size) in float32;
  the next level's feature is the cell's max of f, its coordinate the
  cell's mean of xyz (`voxel.segment_mean`, summed in float64);
- unpooling [UnpoolWithSkip, backend "map"]:
  ReLU(BN(Linear(coarse)))[cell] + ReLU(BN(Linear(skip))), with bias.

Pointcept's base config fixes, and this module keeps as constants:
attn_qkv_bias True, pe_multiplier False, pe_bias True, unpool_backend
"map"; its drop path (0.3) and attention dropout act only in training,
which this module does not run (ROADMAP X-ptv2-train).

Input: clouds (B, N, C_in), all-zero rows are padding and never enter.
Grid sampling before the backbone keeps the first row in row order of
each occupied voxel of `grid_size` (`voxel.first_in_voxel`), as PTv3's.
Levels: level 0 the sampled rows (the patch embed and decoder stage 0),
level s + 1 encoder stage s's.  Level l holds at most `capacity[l] * B *
N` rows (rounded up to 8), each cloud's rows one run after another in
its own order: level 0 in input row order, a pooled level in cell (x, y,
z) order; the real counts stay on the device.  A count above a capacity,
or a grid coordinate of 2^16 or more, sets the call's overflow flag
(`ptv3.OVERFLOW`; `ptv3.raise_on_overflow` raises `CapacityOverflow`
when it is read).  The forward reads nothing back to the host.

Neighbours: each level's kNN is computed once, at the largest k of the
sequences run there, and a sequence at a smaller k takes its first
columns (sorted by (distance, row), so they are the smaller k's sets):
the patch embed's 8 are level 0's first 8 of 16, and decoder stages 1-3
share encoder stages 0-2's sets.

Numerics: each product takes its operands in the compute dtype and
accumulates in float32; BN (folded to a scale and a shift, in float32),
ReLU, the relation and value sums, the softmax, the weighted sum over
the neighbours and the residual are float32.  The GVA is `ops.gva`: on a
CUDA tensor in bf16 at inference one kernel (`csrc/gva.cu`) after the q, k
and v products, elsewhere its plain version.

Under a `torch.profiler` the work is in spans: grid_sample, knn, gva,
grid_pool, grid_unpool.  `counters()` reads the device-side counters the
forwards accumulate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from wireframe_tpu_torch.models.ptv3 import capacity_rows
from wireframe_tpu_torch.ops import gva as gva_op
from wireframe_tpu_torch.ops import knn as knn_op
from wireframe_tpu_torch.ops import voxel
from wireframe_tpu_torch.ops.gva import bn_relu as _bn_relu
from wireframe_tpu_torch.ops.gva import linear as _linear
from wireframe_tpu_torch.ops.masked_pool import point_validity_mask
from wireframe_tpu_torch.utils.profiling import span

BN_EPS = 1e-5
# Pointcept's attn_qkv_bias, which its ScanNet base config leaves True
# (pe_multiplier False, pe_bias True and unpool_backend "map" are the
# structure of `GVA` and `_unpool`).
QKV_BIAS = True


@dataclass
class Level:
    """The packed rows of one level, each cloud's rows one run."""

    xyz: torch.Tensor            # (M, 3) float32, 0 on dummy rows
    batch: torch.Tensor          # (M,) cloud, B on dummy rows
    valid: torch.Tensor          # (M,) bool
    counts: torch.Tensor         # (B,) real rows a cloud
    nbr: Optional[torch.Tensor] = None      # (M, k) kNN, -1 missing
    gather: Optional[torch.Tensor] = None   # nbr with M for -1
    parent: Optional[torch.Tensor] = None   # (M,) coarse row, or M'

    @property
    def rows(self) -> int:
        return self.xyz.shape[0]


class BatchNorm(nn.Module):
    """BatchNorm1d over the last axis with its running statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        shift = self.bias - self.running_mean * scale
        return torch.addcmul(shift, x.float(), scale)


class GVA(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        if c % groups:
            raise ValueError(f"PTv2: {c} channels in {groups} groups")
        self.groups = groups
        self.q = nn.Linear(c, c, bias=QKV_BIAS)
        self.q_bn = BatchNorm(c)
        self.k = nn.Linear(c, c, bias=QKV_BIAS)
        self.k_bn = BatchNorm(c)
        self.v = nn.Linear(c, c, bias=QKV_BIAS)
        self.pe1 = nn.Linear(3, c)
        self.pe_bn = BatchNorm(c)
        self.pe2 = nn.Linear(c, c)
        self.we1 = nn.Linear(c, groups)
        self.we_bn = BatchNorm(groups)
        self.we2 = nn.Linear(groups, groups)

    def forward(self, level: Level, x: torch.Tensor, k: int, dt,
                counters: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`ops.gva`: the kernel where `gva_op.engages`, else the plain
        version.  `counters` (the backbone's gva_real_slots, gva_slots,
        gva_rows_skipped) gain the call's: the kernel counts them itself,
        the plain version skips no row."""
        if gva_op.engages(x.device, dt, torch.is_grad_enabled()):
            return gva_op.gva(self, level, x, k, dt, counters)
        if counters is not None:
            real = ((level.nbr[:, :k] >= 0) & level.valid[:, None]).sum()
            counters[0:1].add_(real)
            counters[1:2].add_(level.rows * k)
        return gva_op.gva_plain(self, level, x, k, dt)


class Block(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.fc1 = nn.Linear(c, c, bias=False)
        self.bn1 = BatchNorm(c)
        self.attn = GVA(c, groups)
        self.bn2 = BatchNorm(c)
        self.fc3 = nn.Linear(c, c, bias=False)
        self.bn3 = BatchNorm(c)

    def forward(self, net: "PTv2Backbone", level: Level, x: torch.Tensor,
                k: int) -> torch.Tensor:
        dt = net.dtype
        h = _bn_relu(_linear(x, self.fc1, dt), self.bn1)
        with span("gva"):
            h = self.attn(level, h, k, dt, net.gva_counters())
        h = _bn_relu(h, self.bn2)
        h = self.bn3(_linear(h, self.fc3, dt))
        return torch.relu_(h.add_(x))


class BlockSequence(nn.Module):
    """A block sequence; `pool` is the patch embed's projection, the
    encoder's pooling or the decoder's unpooling."""

    def __init__(self, c: int, groups: int, depth: int, neighbours: int,
                 pool: nn.Module):
        super().__init__()
        self.neighbours = neighbours
        self.pool = pool
        self.blocks = nn.ModuleList(Block(c, groups) for _ in range(depth))

    def run(self, net: "PTv2Backbone", level: Level, x: torch.Tensor
            ) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(net, level, x, self.neighbours)
        return x


class Projection(nn.Module):
    """ReLU(BN(Linear(cin, cout))): the patch embed's [proj] and grid
    pooling's [fc, norm, act]."""

    def __init__(self, cin: int, cout: int, bias: bool):
        super().__init__()
        self.proj = nn.Linear(cin, cout, bias=bias)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        return _bn_relu(_linear(x, self.proj, dt), self.bn)


class Unpooling(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.bn = BatchNorm(cout)
        self.proj_skip = nn.Linear(cskip, cout)
        self.skip_bn = BatchNorm(cout)


# Counter slots: sums over the forwards since the last reset, except the
# "max" ones (the largest in one call).  knn_slots.levelL: the real
# neighbour slots of the level's kNN (valid rows, index >= 0) at the
# level's largest k; gva_real_slots / gva_slots: a GVA's real neighbour
# slots and the capacity rows x k it computes, summed over the blocks;
# gva_rows_skipped: the rows the GVA kernel wrote as 0 without a product
# (a warp's rows when none has a neighbour: the capacity's dummy rows).
def counter_names(levels: int) -> List[str]:
    names = ["calls", "input_rows", "grid_dropped", "overflow_calls",
             "gva_real_slots", "gva_slots", "gva_rows_skipped"]
    for lv in range(levels):
        names += [f"rows.level{lv}", f"rows_max.level{lv}",
                  f"knn_slots.level{lv}"]
    return names


class PTv2Backbone(nn.Module):
    def __init__(self, in_channels: int = 8, patch_embed_depth: int = 1,
                 patch_embed_channels: int = 48,
                 patch_embed_groups: int = 6,
                 patch_embed_neighbours: int = 8,
                 enc_depths: Sequence[int] = (2, 2, 6, 2),
                 enc_channels: Sequence[int] = (96, 192, 384, 512),
                 enc_groups: Sequence[int] = (12, 24, 48, 64),
                 enc_neighbours: Sequence[int] = (16, 16, 16, 16),
                 dec_depths: Sequence[int] = (1, 1, 1, 1),
                 dec_channels: Sequence[int] = (48, 96, 192, 384),
                 dec_groups: Sequence[int] = (6, 12, 24, 48),
                 dec_neighbours: Sequence[int] = (16, 16, 16, 16),
                 grid_sizes: Sequence[float] = (0.06, 0.12, 0.24, 0.48),
                 grid_size: float = 0.02,
                 capacity: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = len(enc_depths)
        if not (len(enc_channels) == len(enc_groups) == len(enc_neighbours)
                == len(dec_depths) == len(dec_channels) == len(dec_groups)
                == len(dec_neighbours) == len(grid_sizes) == n
                and len(capacity) == n + 1):
            raise ValueError("PTv2: one encoder and one decoder entry and "
                             "one grid size a stage, one capacity a level "
                             "(the stages and the patch embed's)")
        self.dtype = dtype
        self.grid_size = float(grid_size)
        self.grid_sizes = tuple(float(g) for g in grid_sizes)
        self.capacity = tuple(float(c) for c in capacity)
        self.out_channels = dec_channels[0]
        enc_c = [patch_embed_channels] + list(enc_channels)
        dec_c = list(dec_channels) + [enc_c[-1]]
        self.patch_embed = BlockSequence(
            patch_embed_channels, patch_embed_groups, patch_embed_depth,
            patch_embed_neighbours,
            Projection(in_channels, patch_embed_channels, bias=False))
        self.enc = nn.ModuleList(
            BlockSequence(enc_c[s + 1], enc_groups[s], enc_depths[s],
                      enc_neighbours[s],
                      Projection(enc_c[s], enc_c[s + 1], bias=False))
            for s in range(n))
        self.dec = nn.ModuleList(
            BlockSequence(dec_c[s], dec_groups[s], dec_depths[s],
                      dec_neighbours[s],
                      Unpooling(dec_c[s + 1], enc_c[s], dec_c[s]))
            for s in range(n))
        # Each level's largest k: level 0 runs the patch embed and decoder
        # stage 0, level s + 1 encoder stage s and decoder stage s + 1.
        self.level_k = [max(patch_embed_neighbours, dec_neighbours[0])] + [
            max([enc_neighbours[s]]
                + ([dec_neighbours[s + 1]] if s + 1 < n else []))
            for s in range(n)]
        self.names = counter_names(n + 1)
        self.register_buffer("counter_values",
                             torch.zeros(len(self.names), dtype=torch.long),
                             persistent=False)
        self._slot = {k: i for i, k in enumerate(self.names)}

    # -- counters ---------------------------------------------------------

    def gva_counters(self) -> torch.Tensor:
        """gva_real_slots, gva_slots, gva_rows_skipped: a view of three
        int64 on the device."""
        i = self._slot["gva_real_slots"]
        return self.counter_values[i:i + 3]

    def _add(self, name: str, value) -> None:
        i = self._slot[name]
        self.counter_values[i:i + 1].add_(value)

    def _max(self, name: str, value) -> None:
        i = self._slot[name]
        view = self.counter_values[i:i + 1]
        torch.maximum(view, value.reshape(1), out=view)

    def counters(self) -> Dict[str, int]:
        """The counters (a host read: call it after the timed work)."""
        return dict(zip(self.names, self.counter_values.tolist()))

    def reset_counters(self) -> None:
        self.counter_values.zero_()

    def overflowed(self) -> torch.Tensor:
        """The forwards over a capacity since the last reset: a device
        scalar, read by nothing until `raise_on_overflow`."""
        i = self._slot["overflow_calls"]
        return self.counter_values[i].clone()

    # -- levels -------------------------------------------------------------

    def _neighbours(self, level: Level, lv: int) -> None:
        with span("knn"):
            k = self.level_k[lv]
            nbr = knn_op.knn(level.xyz, level.batch,
                             voxel.cloud_offsets(level.counts), k)
            level.nbr = nbr
            level.gather = torch.where(nbr >= 0, nbr,
                                       torch.full_like(nbr, level.rows))
            self._add(f"knn_slots.level{lv}",
                      ((nbr >= 0) & level.valid[:, None]).sum())
            real = level.counts.sum()
            self._add(f"rows.level{lv}", real)
            self._max(f"rows_max.level{lv}", real)

    def _first_level(self, x: torch.Tensor):
        b, n, cin = x.shape
        m = capacity_rows(self.capacity[0], b * n)
        valid_in = point_validity_mask(x)
        sorted_key, grid_rows, order = voxel.first_in_voxel(
            x, valid_in, self.grid_size)
        _, head, count = voxel.pack_runs(sorted_key, b * n)
        # The kept rows in input row order: each cloud's rows one run.
        kept = torch.zeros_like(head).scatter_(0, order, head)
        rank = torch.cumsum(kept.long(), 0) - 1
        point_slot = torch.where(kept & (rank < m), rank,
                                 torch.full_like(rank, m))
        rows = voxel.scatter_rows(torch.arange(b * n, device=x.device),
                                  point_slot, m, b * n)
        valid = rows < b * n
        batch = torch.div(rows, n, rounding_mode="floor")
        xe = torch.cat([x.reshape(b * n, cin).float(),
                        x.new_zeros((1, cin), dtype=torch.float32)])
        feats = xe[rows]
        over = (count > m) | (grid_rows >= (1 << voxel.COORD_BITS)).any()
        real_in = valid_in.sum()
        self._add("input_rows", real_in)
        self._add("grid_dropped", real_in - torch.clamp_max(count, m))
        level = Level(xyz=feats[:, :3].contiguous(), batch=batch,
                      valid=valid,
                      counts=voxel.cloud_counts(batch, valid, b))
        return level, feats, point_slot, over

    def _pool(self, fine: Level, x: torch.Tensor, pool: Projection, m: int,
              clouds: int, grid_size: float):
        key, over = voxel.grid_clusters(fine.xyz, fine.batch, fine.valid,
                                        clouds, grid_size)
        sorted_key, order = torch.sort(key)
        slot, head, count = voxel.pack_runs(sorted_key, m)
        fine.parent = torch.empty_like(slot).scatter_(0, order, slot)
        hslot = torch.where(head, slot, torch.full_like(slot, m))
        ckey = voxel.scatter_rows(sorted_key, hslot, m, voxel.DUMMY_KEY)
        valid = ckey != voxel.DUMMY_KEY
        batch = torch.where(valid, ckey >> voxel.BATCH_SHIFT,
                            torch.full_like(ckey, clouds))
        xyz = voxel.segment_mean(fine.xyz, fine.parent, m)
        h = voxel.segment_max(pool(x, self.dtype), fine.parent, m)
        coarse = Level(xyz=xyz, batch=batch, valid=valid,
                       counts=voxel.cloud_counts(batch, valid, clouds))
        return coarse, h, over | (count > m)

    def _unpool(self, up: Unpooling, fine: Level, x: torch.Tensor,
                skip: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        c = _bn_relu(_linear(x, up.proj, dt), up.bn)
        c = torch.cat([c, c.new_zeros((1, c.shape[1]))])[fine.parent]
        return _bn_relu(_linear(skip, up.proj_skip, dt), up.skip_bn).add_(c)

    # -- the forward ------------------------------------------------------

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
        """(features (M0, C) float32 of level 0's packed rows, each input
        row's packed row (B * N,), M0 for dropped and padding rows, M0, the
        call's overflow flag: a 0-d bool device tensor)."""
        if train:
            raise ValueError("the PTv2 backbone runs at inference only "
                             "(ROADMAP X-ptv2-train)")
        b, n, _ = x.shape
        with span("grid_sample"):
            level, feats, point_slot, over = self._first_level(x)
        self._neighbours(level, 0)
        h = self.patch_embed.pool(feats, self.dtype)
        h = self.patch_embed.run(self, level, h)
        levels, skips = [level], [h]
        for s, stage in enumerate(self.enc):
            with span("grid_pool"):
                m = capacity_rows(self.capacity[s + 1], b * n)
                coarse, h, over_s = self._pool(levels[-1], h, stage.pool, m,
                                               b, self.grid_sizes[s])
            over = over | over_s
            self._neighbours(coarse, s + 1)
            h = stage.run(self, coarse, h)
            levels.append(coarse)
            skips.append(h)
        for s in range(len(self.dec) - 1, -1, -1):
            stage = self.dec[s]
            with span("grid_unpool"):
                h = self._unpool(stage.pool, levels[s], h, skips[s])
            h = stage.run(self, levels[s], h)
        self._add("calls", 1)
        self._add("overflow_calls", over.long())
        return h, point_slot, levels[0].rows, over
