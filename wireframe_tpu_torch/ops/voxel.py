"""Voxels of a packed batch of clouds: grid sampling, space-filling-curve
codes, submanifold neighbour maps and segment reductions; for Point
Transformer V2, grid cells of continuous coordinates (`grid_clusters`),
segment means and the packed clouds' row offsets.

All of it is PyTorch ops, on any device, except the neighbour map of a
CUDA tensor: `neighbour_map` launches `csrc/neighbour_map.cu` there (a
hash table of the level's keys, one lookup a query) and runs
`neighbour_map_plain` (binary searches in the sorted keys) on the CPU.

Everything here is sync-free: every shape is fixed by the caller (a row
capacity), data-dependent counts stay on the device, and rows past a
count are dummies that no real row reads.  A count above its capacity is
flagged, never cut silently (`models.ptv3` raises on the flag).

Codes (Point Transformer V3's `serialization/`):
- `morton_encode`: the z-order code, one bit of x, y, z per level, x the
  most significant of each triple (`z_order.py`'s xyz2key);
- `hilbert_encode`: Skilling's transpose algorithm on 16 bits a
  coordinate (`hilbert.py`'s encode at num_bits 16).  Pointcept takes
  num_bits = the batch's depth d (the bit length of its largest grid
  coordinate); each of the 16 - d leading all-zero levels of the 16-bit
  code rotates the axes (x, y, z) -> (z, x, y) before the levels that
  count, so `hilbert_axes` undoes that rotation on the device, and the
  16-bit code equals Pointcept's d-bit code without reading d back.

Packed rows are sorted by the key `batch << 48 | morton(grid)`; dummy rows
carry `DUMMY_KEY`, which sorts last.  A Morton code shifted right by 3 is
the code of the parent cell (grid >> 1), so pooled rows come out sorted
by their own key, and each parent cell's children are one run of rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wireframe_tpu_torch.ops._launch import (
    check,
    count,
    library,
    on_card,
    ptr,
)

COORD_BITS = 16
BATCH_SHIFT = 3 * COORD_BITS
DUMMY_KEY = (1 << 63) - 1

# Morton bit spreading of a 16-bit integer to every third bit.
_SPREAD = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
           (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
           (2, 0x1249249249249249))


def _spread(v: torch.Tensor) -> torch.Tensor:
    v = v & 0xFFFF
    for shift, mask in _SPREAD:
        v = (v | (v << shift)) & mask
    return v


def morton_encode(grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 grid coordinates (each < 2**16) -> (...) int64
    code."""
    s = _spread(grid)
    return (s[..., 0] << 2) | (s[..., 1] << 1) | s[..., 2]


def hilbert_encode(grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 -> (...) int64 Hilbert index on 16 bits a
    coordinate (Skilling, "Programming the Hilbert curve", 2004)."""
    bits = COORD_BITS
    x = [grid[..., i] for i in range(3)]
    q = 1 << (bits - 1)
    while q > 1:                          # inverse undo
        p = q - 1
        for i in range(3):
            on = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0 = torch.where(on, x[0] ^ p, x[0] ^ t)
            if i:
                x[i] = torch.where(on, x[i], x[i] ^ t)
            x[0] = x0
        q >>= 1
    x[1] = x[1] ^ x[0]                    # Gray encode
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x = [v ^ t for v in x]
    code = torch.zeros_like(x[0])
    for level in range(bits - 1, -1, -1):  # transpose -> index, x first
        for i in range(3):
            code = (code << 1) | ((x[i] >> level) & 1)
    return code


def _columns(grid: torch.Tensor, order) -> torch.Tensor:
    """grid's last axis in `order`, without an index tensor (whose copy
    to the card would wait for it)."""
    return torch.stack([grid[..., i] for i in order], -1)


def hilbert_axes(grid: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """`grid` with its columns permuted so that the 16-bit Hilbert code of
    the result is Pointcept's code at num_bits = `depth` (a 0-d device
    tensor: the batch's bit length): sigma^-k, k = (16 - depth) mod 3,
    where sigma (x, y, z) = (z, x, y)."""
    k = torch.remainder(COORD_BITS - depth, 3)
    return torch.where(k == 0, grid, torch.where(
        k == 1, _columns(grid, (1, 2, 0)), _columns(grid, (2, 0, 1))))


def depth_of(grid: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """0-d int64: the bit length of the largest grid coordinate over the
    valid rows (at least 1), as Pointcept's `serialization` measures it."""
    top = torch.where(valid[:, None], grid,
                      torch.zeros_like(grid)).amax().clamp_min(1)
    return torch.floor(torch.log2(top.double())).long() + 1


def curve_codes(grid: torch.Tensor, orders, depth: torch.Tensor
                ) -> torch.Tensor:
    """(len(orders), M) int64 codes of `grid` for each order name:
    "z", "z-trans", "hilbert", "hilbert-trans" ("-trans": x and y
    swapped first)."""
    swapped = _columns(grid, (1, 0, 2))
    grids = [swapped if name.endswith("-trans") else grid for name in orders]
    codes = {}
    for curve in ("z", "hilbert"):
        at = [i for i, name in enumerate(orders) if name.startswith(curve)]
        if not at:
            continue
        # Every order of one curve at once, in one pass of its loop.
        g = torch.stack([grids[i] for i in at])
        c = (morton_encode(g) if curve == "z"
             else hilbert_encode(hilbert_axes(g, depth)))
        codes.update(zip(at, c.unbind(0)))
    return torch.stack([codes[i] for i in range(len(orders))])


def first_in_voxel(x: torch.Tensor, valid: torch.Tensor, grid_size: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid coordinates and grid sampling of clouds x (B, N, C).

    Grid coordinates are floor((xyz - cloud min) / grid_size) in float32,
    the min over the cloud's valid rows.  Returns (key (B*N,) int64 with
    DUMMY_KEY on invalid rows, grid (B*N, 3) int64, order (B*N,): the
    rows stably sorted by key) and marks, through the sorted keys, the
    first row in row order of each occupied voxel."""
    b, n = valid.shape
    xyz = x[..., :3].float()
    lo = torch.where(valid[..., None], xyz,
                     torch.full_like(xyz, torch.inf)).amin(1, keepdim=True)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    grid = torch.floor((xyz - lo) / grid_size).long().clamp_min(0)
    grid = torch.where(valid[..., None], grid, torch.zeros_like(grid))
    grid = grid.reshape(b * n, 3)
    batch = torch.arange(b, device=x.device).repeat_interleave(n)
    key = (batch << BATCH_SHIFT) | morton_encode(grid)
    key = torch.where(valid.reshape(-1), key,
                      torch.full_like(key, DUMMY_KEY))
    sorted_key, order = torch.sort(key, stable=True)
    return sorted_key, grid, order


def pack_runs(sorted_key: torch.Tensor, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The runs of equal keys in `sorted_key` (DUMMY_KEY excluded), each
    given a row of a packed array of `capacity` rows in key order.

    Returns (slot (M,): the packed row of each entry's run, `capacity`
    for dummies and past the capacity; head (M,) bool: the entry opens
    its run; count 0-d: the number of runs, which may exceed
    `capacity`)."""
    real = sorted_key != DUMMY_KEY
    prev = torch.cat([sorted_key.new_full((1,), -1), sorted_key[:-1]])
    head = real & (sorted_key != prev)
    run = torch.cumsum(head.long(), 0) - 1
    count = run[-1] + 1 if run.numel() else run.new_zeros(())
    slot = torch.where(real & (run < capacity), run,
                       torch.full_like(run, capacity))
    return slot, head, count


def scatter_rows(values: torch.Tensor, slot: torch.Tensor, capacity: int,
                 fill=0) -> torch.Tensor:
    """A (capacity, ...) array holding values[i] at row slot[i]; slots at
    `capacity` are dropped, rows no entry names hold `fill`."""
    out = values.new_full((capacity + 1,) + tuple(values.shape[1:]), fill)
    out.index_copy_(0, slot, values)
    return out[:capacity]


# Rows past the kept ones that a segment reduction sends its dropped rows
# to (`spread_drops`).
DROP_SINKS = 1024


def spread_drops(slot: torch.Tensor, capacity: int) -> torch.Tensor:
    """`slot` with each entry at `capacity` (a dropped row) sent to one of
    `DROP_SINKS` rows past it, by its position: a level's dummy rows (~30%
    of its capacity) would otherwise queue their atomics on one address,
    in a time that grows with their number and so with the clouds."""
    sink = capacity + torch.arange(slot.shape[0], device=slot.device) \
        % DROP_SINKS
    return torch.where(slot < capacity, slot, sink)


def segment_max(values: torch.Tensor, slot: torch.Tensor, capacity: int
                ) -> torch.Tensor:
    """(capacity, C): the max of the rows of `values` sent to each slot
    (`capacity` drops the row); a slot no row reaches holds 0."""
    c = values.shape[-1]
    out = values.new_zeros((capacity + DROP_SINKS, c))
    out = out.scatter_reduce(
        0, spread_drops(slot, capacity)[:, None].expand(-1, c), values,
        reduce="amax", include_self=False)
    return out[:capacity]


# Queries (rows x offsets) of one chunk of the plain neighbour search.
NEIGHBOUR_QUERIES = 1 << 24
# The map sizes `csrc/neighbour_map.cu` is built for (held to it at load).
MAP_SIZES = (3, 5)


def neighbour_map_plain(key: torch.Tensor, grid: torch.Tensor,
                        batch: torch.Tensor, valid: torch.Tensor, size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`neighbour_map` in PyTorch ops, a chunk of rows at a time: every
    (row, offset) query's key looked up by binary search in the sorted
    keys."""
    m = key.shape[0]
    r = torch.arange(-(size // 2), size // 2 + 1, device=key.device)
    offsets = torch.cartesian_prod(r, r, r)
    chunk = max(1, NEIGHBOUR_QUERIES // size ** 3)
    nbr, found = [], key.new_zeros(())
    for s in range(0, m, chunk):
        g = grid[s:s + chunk, None, :] + offsets          # (R, K, 3)
        inside = (((g >= 0) & (g < (1 << COORD_BITS))).all(-1)
                  & valid[s:s + chunk, None])
        q = ((batch[s:s + chunk, None] << BATCH_SHIFT)
             | morton_encode(g.clamp(0, 0xFFFF)))
        idx = torch.searchsorted(key, q).clamp_max(m - 1)
        hit = inside & (key[idx] == q)
        nbr.append(torch.where(hit, idx, torch.full_like(idx, m)))
        found = found + hit.sum()
    return torch.cat(nbr) if len(nbr) > 1 else nbr[0], found


def neighbour_map(key: torch.Tensor, grid: torch.Tensor, batch: torch.Tensor,
                  valid: torch.Tensor, size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Submanifold neighbours of the packed rows (sorted by `key`, valid
    rows' keys distinct).

    Returns (nbr (M, size**3) int64: for each row and offset the packed
    row of the active voxel there, M (a zero row) where there is none or
    the row is not valid; pairs 0-d int64: the number of (row, offset)
    pairs found).  The offsets (dx, dy, dz) over [-r, r]^3, r = size //
    2, run in lexicographic order, dz fastest.  A CPU tensor takes
    `neighbour_map_plain`, a CUDA tensor the kernel (`csrc/
    neighbour_map.cu`: a hash table of the level's keys, then one lookup
    a query; sizes `MAP_SIZES`), any other device raises.  Each kernel
    call counts "neighbour map" (`ops._launch`)."""
    if not on_card(key, "the neighbour map"):
        return neighbour_map_plain(key, grid, batch, valid, size)
    return _launch_map(key, grid, batch, valid, size)


def table_slots(m: int) -> int:
    """Slots of the kernel's hash table for M rows: the least power of
    two of at least 2M, so the table is at most half full."""
    return 1 << (2 * m - 1).bit_length()


def _check_library(lib) -> None:
    built = tuple(s for s in (lib.nbr_map_size(i) for i in range(3))
                  if s > 0)
    if built != MAP_SIZES:
        raise RuntimeError(f"csrc/neighbour_map.cu is built for sizes "
                           f"{built}; ops/voxel.py says {MAP_SIZES}")


def _lib():
    return library("neighbour_map", {"neighbour_map": "P" * 6 + "iii" + "P",
                                     "nbr_map_size": "i"}, _check_library)


def _launch_map(key, grid, batch, valid, size):
    m = key.shape[0]
    if size not in MAP_SIZES:
        raise ValueError(f"the neighbour map kernel is built for sizes "
                         f"{MAP_SIZES}, not {size}")
    if not 1 <= m < (1 << 30):
        raise ValueError(f"the neighbour map kernel takes 1 <= M < 2**30 "
                         f"rows; got {m}")
    if (key.shape != (m,) or grid.shape != (m, 3) or batch.shape != (m,)
            or valid.shape != (m,)):
        raise ValueError(f"key (M,), grid (M, 3), batch (M,), valid (M,) "
                         f"for M = {m}; got {tuple(key.shape)}, "
                         f"{tuple(grid.shape)}, {tuple(batch.shape)}, "
                         f"{tuple(valid.shape)}")
    if (key.dtype, grid.dtype, batch.dtype, valid.dtype) != (
            torch.int64, torch.int64, torch.int64, torch.bool):
        raise ValueError("key, grid and batch int64, valid bool")
    if any(t.device != key.device for t in (grid, batch, valid)):
        raise ValueError("the neighbour map's tensors must lie on one device")
    slots = table_slots(m)
    nbr = torch.empty((m, size ** 3), dtype=torch.int64, device=key.device)
    # The pairs count, then the table's int32 slots; the kernel zeroes it.
    work = torch.empty(1 + slots // 2, dtype=torch.int64, device=key.device)
    args = [t.contiguous() for t in (key, grid, batch, valid)]
    stream = torch.cuda.current_stream(key.device).cuda_stream
    check(_lib().neighbour_map(*map(ptr, args), ptr(nbr), ptr(work), m, size,
                               slots.bit_length() - 1, stream),
          "neighbour map")
    count("neighbour map")
    return nbr, work[0]


def grid_clusters(xyz: torch.Tensor, batch: torch.Tensor,
                  valid: torch.Tensor, clouds: int, grid_size: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid cells of rows at continuous coordinates (Point Transformer V2's
    GridPool): cell = floor((xyz - the cloud's start) / grid_size) in
    float32, the start the least coordinate over the cloud's valid rows.

    Returns (key (M,) int64: batch << 48 | x << 32 | y << 16 | z, so rows
    sorted by key hold each cloud's cells in (x, y, z) order, DUMMY_KEY on
    invalid rows; over 0-d bool: a valid row's cell at 2^16 or more)."""
    b = torch.where(valid, batch, torch.full_like(batch, clouds))
    lo = xyz.new_full((clouds + DROP_SINKS, 3), torch.inf).scatter_reduce(
        0, spread_drops(b, clouds)[:, None].expand(-1, 3), xyz,
        reduce="amin", include_self=True)
    cell = torch.floor((xyz - lo[b]) / grid_size)
    cell = torch.where(valid[:, None] & torch.isfinite(cell), cell,
                       torch.zeros_like(cell)).long().clamp_min(0)
    over = (cell >= (1 << COORD_BITS)).any()
    cell = cell & 0xFFFF
    key = ((b << BATCH_SHIFT) | (cell[:, 0] << 32) | (cell[:, 1] << 16)
           | cell[:, 2])
    return torch.where(valid, key, torch.full_like(key, DUMMY_KEY)), over


def segment_mean(values: torch.Tensor, slot: torch.Tensor, capacity: int
                 ) -> torch.Tensor:
    """(capacity, C): the mean of the rows of `values` sent to each slot
    (`capacity` drops the row), summed in float64 and rounded once to
    `values`' dtype, so the order of the sum does not show; a slot no row
    reaches holds 0."""
    c = values.shape[-1]
    slot = spread_drops(slot, capacity)
    sums = values.new_zeros((capacity + DROP_SINKS, c), dtype=torch.float64)
    sums.index_add_(0, slot, values.double())
    n = values.new_zeros((capacity + DROP_SINKS,), dtype=torch.float64)
    n.index_add_(0, slot, torch.ones_like(slot, dtype=torch.float64))
    return (sums[:capacity] / n[:capacity].clamp_min(1.0)[:, None]).to(
        values.dtype)


def cloud_offsets(counts: torch.Tensor) -> torch.Tensor:
    """(B + 1,) int64: each cloud's first packed row, then the real
    rows' count, for clouds packed one after another."""
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def cloud_counts(batch: torch.Tensor, valid: torch.Tensor, clouds: int
                 ) -> torch.Tensor:
    """(clouds,) int64 valid rows a cloud (no host read, unlike
    `torch.bincount`)."""
    out = batch.new_zeros(clouds + 1)
    idx = torch.where(valid, batch, torch.full_like(batch, clouds))
    out.scatter_add_(0, idx, torch.ones_like(idx))
    return out[:clouds]
