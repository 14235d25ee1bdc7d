"""Point Transformer V3 backbone (Wu et al., CVPR 2024, arXiv:2312.10035),
as Pointcept's `point_transformer_v3m1_base.py` builds it, on a packed
batch of fixed row capacities.

Layers (Pointcept's names in brackets):
- stem [Embedding]: SubMConv3d(in, C0, k=5, no bias) -> BatchNorm -> GELU;
- encoder stage s: [SerializedPooling] for s > 0, then `enc_depths[s]`
  blocks; decoder stage s (from the deepest up): [SerializedUnpooling],
  then `dec_depths[s]` blocks;
- block, pre-norm: x += LN(Linear(SubMConv3d_k3(x))) [xCPE];
  x += Attn(LN(x)); x += MLP(LN(x)) (C -> 4C, GELU, 4C -> C); stochastic
  depth on each residual branch in training, per row;
- Attn: qkv Linear, multi-head attention inside patches of `patch` rows
  in the serialized order `ORDERS[i % 4]` of block i
  (`ops.patch_attention`), output Linear;
- pooling (stride 2): rows whose Morton code agrees above its last 3
  bits (one parent cell of grid >> 1) form a cluster; the cluster's max
  of Linear(in, out), then BatchNorm and GELU; every curve's code is
  shifted right by 3, as Pointcept shifts it;
- unpooling: BN-GELU(Linear(coarse))[parent] + BN-GELU(Linear(skip)).
BatchNorm eps 1e-3, momentum 0.01; LayerNorm eps 1e-5; GELU exact.

Pointcept's base config fixes, and this module keeps as constants:
mlp_ratio 4, qkv_bias True, the orders ("z", "z-trans", "hilbert",
"hilbert-trans") and stride 2 at every pooling.

Input: clouds (B, N, C_in), all-zero rows are padding and never enter.
Grid coordinates floor((xyz - cloud min) / grid_size) in float32; grid
sampling keeps the first row in row order of each occupied voxel, the
others become masked rows.  Stage s holds at most `capacity[s] * B * N`
rows (rounded up to 8); the real count stays on the device.  A count
above a capacity, or a grid coordinate of 2^16 or more, sets the call's
overflow flag, a device tensor the forward returns beside its outputs
(`OVERFLOW`); `raise_on_overflow` raises `CapacityOverflow` when it is
read with them, and the process and its CUDA context carry on.  The
forward reads nothing back to the host.

Numerics: each product takes its operands in the compute dtype and
accumulates in float32 (`layers.dense`); the residual stream, norms and
GELU inputs are float32.  The cluster mean of the coordinates, which
Pointcept carries along, is not computed: without relative positional
encoding nothing reads it.

Training (`train=True`): BatchNorm statistics over real rows only (its
running statistics updated in place), stochastic depth, and the four
curves shuffled at every level from the caller's generator, as
Pointcept's `shuffle_orders`; inference keeps the published order.

Under a `torch.profiler` the work is in spans: serialize (grid sampling,
codes, orders, patch layouts), sparse_conv (neighbour maps and the
gather-GEMM convolutions: `csrc/neighbour_map.cu` and `csrc/subm_conv.cu`
on the card), patch_attn, grid_pool, grid_unpool.
`counters()` reads the device-side counters the forwards accumulate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wireframe_tpu_torch.ops import subm_conv, voxel
from wireframe_tpu_torch.ops.patch_attention import (
    Layout,
    patch_layout,
    segment_attention,
)
from wireframe_tpu_torch.ops.masked_pool import point_validity_mask
from wireframe_tpu_torch.utils.profiling import span

BN_EPS, BN_MOMENTUM, LN_EPS = 1e-3, 0.01, 1e-5
# Pointcept's `PointTransformerV3` defaults, which its ScanNet base config
# keeps: the MLP's hidden width over C, the qkv bias, the serialization
# orders, and each pooling's stride 2 (one bit of every grid axis).
MLP_RATIO, QKV_BIAS, POOL_SHIFT = 4, True, 1
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
# The key under which the model's outputs carry the call's overflow flag.
OVERFLOW = "capacity_overflow"


class CapacityOverflow(RuntimeError):
    """A stage's real rows exceeded its packed capacity, so rows were
    left out of that call's result."""


def raise_on_overflow(outputs) -> None:
    """Raise `CapacityOverflow` if `outputs` carry an overflow flag (or
    count) above zero.  A host read: call it where the outputs are read
    back, not between forwards that are queued."""
    flag = outputs.get(OVERFLOW)
    if flag is not None and bool(flag):
        raise CapacityOverflow(
            "a stage's rows exceed its capacity (model.ptv3_capacity or "
            "model.ptv2_capacity) or a grid coordinate is 2**16 or more; "
            "this call's outputs leave rows out")


def capacity_rows(fraction: float, rows: int) -> int:
    """A stage's packed rows for `rows` input rows (B * N)."""
    return max(8, int(math.ceil(fraction * rows / 8.0)) * 8)


@dataclass
class Level:
    """The packed rows of one stage, sorted by `key` (dummies last)."""

    key: torch.Tensor            # (M,) batch << 48 | morton, DUMMY_KEY
    grid: torch.Tensor           # (M, 3) int64
    batch: torch.Tensor          # (M,) cloud, B on dummy rows
    valid: torch.Tensor          # (M,) bool
    counts: torch.Tensor         # (B,) real rows a cloud
    codes: torch.Tensor          # (len(orders), M) curve codes
    layouts: Dict[int, Layout] = field(default_factory=dict)
    nbr: Dict[int, torch.Tensor] = field(default_factory=dict)
    parent: Optional[torch.Tensor] = None   # (M,) coarse row, or M'
    stage: int = 0

    @property
    def rows(self) -> int:
        return self.key.shape[0]


class BatchNorm(nn.Module):
    """BatchNorm1d over the real rows of a level."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                train: bool) -> torch.Tensor:
        x = x.float()
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            m = valid[:, None].float()
            n = m.sum().clamp_min(1.0)
            mean = (x * m).sum(0) / n
            var = (torch.square(x - mean) * m).sum(0) / n
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), BN_MOMENTUM)
                self.running_var.lerp_(
                    var.detach() * n / (n - 1.0).clamp_min(1.0), BN_MOMENTUM)
        return (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight \
            + self.bias


def _ln(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, LN_EPS)


def _linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    y = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
    return y if lin.bias is None else y + lin.bias.to(dtype)


class SubMConv(nn.Module):
    """Submanifold sparse convolution (spconv's SubMConv3d): each active
    voxel sums W_o x[neighbour at offset o] over the size**3 offsets
    (`voxel.neighbour_map`'s order).  The weight is (out, size**3 * in),
    the offsets' input channels side by side.  `ops.subm_conv`'s kernel
    where `subm_conv.engages` (inference in bf16 on the card at a shape
    the kernel takes), else its plain gather and GEMM per chunk of
    rows."""

    def __init__(self, cin: int, cout: int, size: int, bias: bool):
        super().__init__()
        k = size ** 3
        self.weight = nn.Parameter(torch.randn(cout, k * cin)
                                   / math.sqrt(k * cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, nbr: torch.Tensor, dtype,
                counters: Optional[torch.Tensor] = None) -> torch.Tensor:
        if subm_conv.engages(x.device, dtype, torch.is_grad_enabled(),
                             x.shape[1], self.weight.shape[0], nbr.shape[1]):
            return subm_conv.subm_conv(x, nbr, self.weight, self.bias,
                                       dtype=dtype, counters=counters)
        return subm_conv.subm_conv_plain(x, nbr, self.weight, self.bias,
                                         dtype=dtype)


def _drop_path(x: torch.Tensor, rate: float, train: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    if not train or rate == 0.0:
        return x
    keep = torch.rand((x.shape[0], 1), generator=generator,
                      device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class Block(nn.Module):
    def __init__(self, c: int, heads: int, order_index: int,
                 drop_path: float, patch: int):
        super().__init__()
        self.heads, self.order_index = heads, order_index
        self.drop_path, self.patch = drop_path, patch
        self.cpe_conv = SubMConv(c, c, 3, bias=True)
        self.cpe_fc = nn.Linear(c, c)
        self.ln_cpe = nn.LayerNorm(c, eps=LN_EPS)
        self.ln_attn = nn.LayerNorm(c, eps=LN_EPS)
        self.qkv = nn.Linear(c, 3 * c, bias=QKV_BIAS)
        self.proj = nn.Linear(c, c)
        self.ln_mlp = nn.LayerNorm(c, eps=LN_EPS)
        hidden = c * MLP_RATIO
        self.fc1 = nn.Linear(c, hidden)
        self.fc2 = nn.Linear(hidden, c)

    def forward(self, net: "PTv3Backbone", level: Level, x: torch.Tensor,
                train: bool, generator) -> torch.Tensor:
        dt = net.dtype
        with span("sparse_conv"):
            nbr = net.neighbours(level, 3)
            h = self.cpe_conv(x, nbr, dt, net.conv_counters())
        x = x + _ln(_linear(h, self.cpe_fc, dt), self.ln_cpe)
        h = _ln(x, self.ln_attn)
        qkv = _linear(h, self.qkv, dt)
        with span("patch_attn"):
            lay = net.layout(level, self.order_index)
            m, c3 = qkv.shape
            c = c3 // 3
            hd = c // self.heads
            # The dummy rows after the last segment read a zero row, and
            # their gradients (which the flash backward leaves unset) go
            # back to it alone.
            qkv = torch.cat([qkv, qkv.new_zeros((1, c3))])
            qp = qkv[lay.src].view(-1, 3, self.heads, hd)
            q, k, v = (qp[:, i].contiguous() for i in range(3))
            a = segment_attention(q, k, v, lay.cu, self.patch)
            h = a.reshape(-1, c)[lay.dst]
            net.count_attention(level, lay)
        h = _linear(h, self.proj, dt)
        x = x + _drop_path(h.float(), self.drop_path, train, generator)
        h = _linear(_ln(x, self.ln_mlp), self.fc1, dt)
        h = _linear(F.gelu(h.float()), self.fc2, dt)
        return x + _drop_path(h.float(), self.drop_path, train, generator)


class Pooling(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.bn = BatchNorm(cout)


class Unpooling(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.bn = BatchNorm(cout)
        self.proj_skip = nn.Linear(cskip, cout)
        self.bn_skip = BatchNorm(cout)


class Stage(nn.Module):
    """A stage's pooling (encoder, after the first) or unpooling
    (decoder), then its blocks."""

    def __init__(self, blocks: List[Block], pool: Optional[nn.Module]):
        super().__init__()
        if pool is not None:
            self.pool = pool
        self.blocks = nn.ModuleList(blocks)


# Counter slots: sums over the forwards since the last reset, except the
# "max" ones (the largest in one call).  conv_steps_run / _skipped: the
# conv kernel's (block, offset) steps, which it adds itself (none on the
# plain path).
def counter_names(stages: int) -> List[str]:
    names = ["calls", "input_rows", "grid_dropped", "attn_real_rows",
             "attn_padded_rows", "overflow_calls", "conv_pairs.stem",
             "conv_steps_run", "conv_steps_skipped"]
    for s in range(stages):
        names += [f"conv_pairs.stage{s}", f"rows.stage{s}",
                  f"rows_max.stage{s}"]
    return names


class PTv3Backbone(nn.Module):
    def __init__(self, in_channels: int = 8,
                 enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
                 enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
                 enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
                 dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dec_channels: Sequence[int] = (64, 64, 128, 256),
                 dec_num_head: Sequence[int] = (4, 4, 8, 16),
                 patch_size: int = 1024, drop_path: float = 0.3,
                 grid_size: float = 0.02,
                 capacity: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = len(enc_depths)
        if not (len(enc_channels) == len(enc_num_head) == len(capacity) == n
                and len(dec_depths) == len(dec_channels)
                == len(dec_num_head) == n - 1):
            raise ValueError("PTv3: one encoder entry a stage, one decoder "
                             "entry a stage after the first")
        self.dtype = dtype
        self.patch = int(patch_size)
        self.grid_size = float(grid_size)
        self.capacity = tuple(float(c) for c in capacity)
        self.out_channels = dec_channels[0]
        self.stem_conv = SubMConv(in_channels, enc_channels[0], 5, bias=False)
        self.stem_bn = BatchNorm(enc_channels[0])
        rates = torch.linspace(0, drop_path, sum(enc_depths),
                               device="cpu").tolist()
        self.enc = nn.ModuleList()
        for s in range(n):
            pool = (Pooling(enc_channels[s - 1], enc_channels[s])
                    if s else None)
            r = rates[sum(enc_depths[:s]):sum(enc_depths[:s + 1])]
            self.enc.append(Stage([
                Block(enc_channels[s], enc_num_head[s], i % len(ORDERS),
                      r[i], self.patch)
                for i in range(enc_depths[s])], pool))
        rates = torch.linspace(0, drop_path, sum(dec_depths),
                               device="cpu").tolist()
        chans = list(dec_channels) + [enc_channels[-1]]
        self.dec = nn.ModuleList()
        for s in range(n - 1):
            r = rates[sum(dec_depths[:s]):sum(dec_depths[:s + 1])][::-1]
            up = Unpooling(chans[s + 1], enc_channels[s], chans[s])
            self.dec.append(Stage([
                Block(chans[s], dec_num_head[s], i % len(ORDERS), r[i],
                      self.patch)
                for i in range(dec_depths[s])], up))
        self.names = counter_names(n)
        self.register_buffer("counter_values",
                             torch.zeros(len(self.names), dtype=torch.long),
                             persistent=False)
        self._slot = {k: i for i, k in enumerate(self.names)}

    # -- counters ---------------------------------------------------------

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

    def conv_counters(self) -> torch.Tensor:
        """The two slots the conv kernel adds its steps run and skipped
        to (a view of the counters)."""
        i = self._slot["conv_steps_run"]
        return self.counter_values[i:i + 2]

    def overflowed(self) -> torch.Tensor:
        """The forwards over a capacity since the last reset: a device
        scalar, read by nothing until `raise_on_overflow`."""
        i = self._slot["overflow_calls"]
        return self.counter_values[i].clone()

    def count_attention(self, level: Level, lay: Layout) -> None:
        real = level.counts.sum()
        self._add("attn_real_rows", real)
        self._add("attn_padded_rows", lay.rows - real)

    # -- per-level structure, built once and shared by a stage's blocks --

    def neighbours(self, level: Level, size: int) -> torch.Tensor:
        if size not in level.nbr:
            nbr, pairs = voxel.neighbour_map(level.key, level.grid,
                                             level.batch, level.valid, size)
            level.nbr[size] = nbr
            self._add("conv_pairs.stem" if size == 5
                      else f"conv_pairs.stage{level.stage}", pairs)
        return level.nbr[size]

    def layout(self, level: Level, index: int) -> Layout:
        if index not in level.layouts:
            with span("serialize"):
                key = torch.where(
                    level.valid,
                    (level.batch << voxel.BATCH_SHIFT) | level.codes[index],
                    torch.full_like(level.key, voxel.DUMMY_KEY))
                _, order = torch.sort(key, stable=True)
                inverse = torch.empty_like(order)
                inverse.scatter_(0, order, torch.arange(
                    order.shape[0], device=order.device))
                level.layouts[index] = patch_layout(order, inverse,
                                                    level.counts, self.patch)
        return level.layouts[index]

    def _shuffle(self, codes: torch.Tensor, train: bool, generator):
        if not train:
            return codes
        perm = torch.randperm(codes.shape[0], generator=generator,
                              device=codes.device)
        return codes.index_select(0, perm)

    # -- the forward ------------------------------------------------------

    def _first_level(self, x: torch.Tensor, train: bool, generator):
        b, n, cin = x.shape
        m = capacity_rows(self.capacity[0], b * n)
        valid_in = point_validity_mask(x)
        sorted_key, grid_rows, order = voxel.first_in_voxel(
            x, valid_in, self.grid_size)
        slot, head, count = voxel.pack_runs(sorted_key, m)
        hslot = torch.where(head, slot, torch.full_like(slot, m))
        key = voxel.scatter_rows(sorted_key, hslot, m, voxel.DUMMY_KEY)
        grid = voxel.scatter_rows(grid_rows[order], hslot, m, 0)
        rows = voxel.scatter_rows(order, hslot, m, b * n)
        valid = key != voxel.DUMMY_KEY
        batch = torch.where(valid, key >> voxel.BATCH_SHIFT,
                            torch.full_like(key, b))
        # Each input row's packed row (m: dropped or padding).
        point_slot = torch.full_like(order, m).scatter_(0, order, hslot)
        depth = voxel.depth_of(grid, valid)
        codes = voxel.curve_codes(grid, ORDERS, depth)
        codes = self._shuffle(codes, train, generator)
        over = (count > m) | ((grid_rows >= (1 << voxel.COORD_BITS))
                              .any())
        real_in = valid_in.sum()
        self._add("input_rows", real_in)
        self._add("grid_dropped", real_in - torch.clamp_max(count, m))
        xe = torch.cat([x.reshape(b * n, cin).float(),
                        x.new_zeros((1, cin), dtype=torch.float32)])
        feats = xe[rows]
        level = Level(key=key, grid=grid, batch=batch, valid=valid,
                      counts=voxel.cloud_counts(batch, valid, b),
                      codes=codes)
        return level, feats, point_slot, over

    def _pool(self, fine: Level, x: torch.Tensor, pool: Pooling, m: int,
              clouds: int, train: bool, generator):
        k = POOL_SHIFT
        morton = fine.key & ((1 << voxel.BATCH_SHIFT) - 1)
        pkey = torch.where(fine.valid,
                           (fine.batch << voxel.BATCH_SHIFT)
                           | (morton >> (3 * k)),
                           torch.full_like(fine.key, voxel.DUMMY_KEY))
        slot, head, count = voxel.pack_runs(pkey, m)
        hslot = torch.where(head, slot, torch.full_like(slot, m))
        key = voxel.scatter_rows(pkey, hslot, m, voxel.DUMMY_KEY)
        valid = key != voxel.DUMMY_KEY
        batch = torch.where(valid, key >> voxel.BATCH_SHIFT,
                            torch.full_like(key, clouds))
        grid = voxel.scatter_rows(fine.grid >> k, hslot, m, 0)
        codes = voxel.scatter_rows((fine.codes >> (3 * k)).t(), hslot, m,
                                   0).t().contiguous()
        codes = self._shuffle(codes, train, generator)
        fine.parent = slot
        h = _linear(x, pool.proj, self.dtype)
        h = voxel.segment_max(h, slot, m)
        coarse = Level(key=key, grid=grid, batch=batch, valid=valid,
                       counts=voxel.cloud_counts(batch, valid, clouds),
                       codes=codes)
        return coarse, h, count > m

    def _unpool(self, up: Unpooling, coarse: Level, fine: Level,
                x: torch.Tensor, skip: torch.Tensor, train: bool
                ) -> torch.Tensor:
        dt = self.dtype
        c = F.gelu(up.bn(_linear(x, up.proj, dt), coarse.valid, train))
        c = torch.cat([c, c.new_zeros((1, c.shape[1]))])[fine.parent]
        return F.gelu(up.bn_skip(_linear(skip, up.proj_skip, dt),
                                 fine.valid, train)) + c

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
        """(features (M0, C) float32 of the stage-0 packed rows, each input
        row's packed row (B * N,), M0 for dropped and padding rows, M0, the
        call's overflow flag: a 0-d bool device tensor)."""
        b, n, _ = x.shape
        dt = self.dtype
        with span("serialize"):
            level, feats, point_slot, over = self._first_level(x, train,
                                                               generator)
        with span("sparse_conv"):
            h = self.stem_conv(feats, self.neighbours(level, 5), dt,
                               self.conv_counters())
        x_ = F.gelu(self.stem_bn(h, level.valid, train))
        levels, skips = [], []
        for s, stage in enumerate(self.enc):
            if s:
                with span("grid_pool"):
                    m = capacity_rows(self.capacity[s], b * n)
                    coarse, h, over_s = self._pool(
                        levels[-1], x_, stage.pool, m, b, train, generator)
                    x_ = F.gelu(stage.pool.bn(h, coarse.valid, train))
                over = over | over_s
                level = coarse
                level.stage = s
            levels.append(level)
            for blk in stage.blocks:
                x_ = blk(self, level, x_, train, generator)
            skips.append(x_)
            self._add(f"rows.stage{s}", level.counts.sum())
            self._max(f"rows_max.stage{s}", level.counts.sum())
        for s in range(len(self.dec) - 1, -1, -1):
            stage, fine = self.dec[s], levels[s]
            up = stage.pool
            with span("grid_unpool"):
                x_ = self._unpool(up, levels[s + 1], fine, x_, skips[s],
                                  train)
            for blk in stage.blocks:
                x_ = blk(self, fine, x_, train, generator)
        self._add("calls", 1)
        self._add("overflow_calls", over.long())
        return x_, point_slot, levels[0].rows, over
