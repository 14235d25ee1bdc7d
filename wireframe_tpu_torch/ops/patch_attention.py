"""Patch attention over serialized rows with Point Transformer V3's padding.

Each cloud's rows, in the serialized order of one curve, are cut into
patches of `patch` rows (Pointcept's `get_padding_and_inverse`):
- a cloud of more than `patch` rows is padded up to a multiple of
  `patch` by repeating, at the end of its last patch, the rows `patch`
  places earlier;
- a cloud of at most `patch` rows is one segment of its own length;
- the outputs of padding rows are dropped.

`patch_layout` lays the segments of a packed batch out one after another
in a fixed number of rows (`attention_capacity`: the packed capacity plus
the most padding that capacity can take), all without a host read; the
dummy rows after the last segment belong to none and are not computed.
`segment_attention` runs multi-head attention inside each segment: on a
CUDA card in half precision through FlashAttention's variable-length
kernel (`aten._flash_attention_forward`, the kernel Pointcept's flash path
calls), elsewhere as a dense masked product over segments laid out in
(segments, patch) slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def attention_capacity(capacity: int, clouds: int, patch: int) -> int:
    """Rows of the padded layout of `capacity` packed rows: every cloud
    above `patch` rows adds at most patch - 1 rows, and at most
    capacity // (patch + 1) clouds are above it."""
    return capacity + (patch - 1) * min(clouds, capacity // (patch + 1))


def segment_capacity(capacity: int, clouds: int, patch: int) -> int:
    """Segments of the padded layout at most: ceil(n / patch) a cloud."""
    return clouds + capacity // patch


@dataclass
class Layout:
    """One curve's padded layout of a level's packed rows."""

    src: torch.Tensor       # (A,) packed row read into each padded row,
    #                         M (a zero row) for the dummies
    dst: torch.Tensor       # (M,) padded row whose output each packed row takes
    cu: torch.Tensor        # (S + 1,) int32 segment starts, then `rows`
    rows: torch.Tensor      # 0-d: real padded rows (the rest are dummies)


def patch_layout(order: torch.Tensor, inverse: torch.Tensor,
                 counts: torch.Tensor, patch: int) -> Layout:
    """The padded layout of packed rows in the serialized `order` (M,)
    (its `inverse`), whose clouds hold `counts` (B,) rows each, in cloud
    order, followed by dummy rows."""
    m, b = order.shape[0], counts.shape[0]
    dev = order.device
    a = attention_capacity(m, b, patch)
    padded = torch.where(counts > patch, -(-counts // patch) * patch, counts)
    segs = -(-counts // patch)
    start = torch.cumsum(counts, 0) - counts           # serialized offsets
    off_end = torch.cumsum(padded, 0)
    off = off_end - padded                              # padded offsets
    seg_base = torch.cumsum(segs, 0) - segs
    total = off_end[-1]
    t = torch.arange(a, device=dev)
    cloud = torch.searchsorted(off_end, t, right=True)  # b for dummies
    real = cloud < b
    cl = cloud.clamp_max(b - 1)
    pos = t - off[cl]
    n = counts[cl]
    src_rank = start[cl] + torch.where(pos < n, pos, pos - patch)
    src = torch.where(real, order[src_rank.clamp(0, m - 1)],
                      torch.full_like(t, m))
    s_cap = segment_capacity(m, b, patch)
    seg = torch.where(real, seg_base[cl] + pos // patch,
                      torch.full_like(t, s_cap))
    # Segment starts; the segments no cloud fills, and the end, at `total`:
    # the dummy rows after it belong to no segment and are never computed.
    first = torch.zeros(s_cap + 1, dtype=torch.long, device=dev) + total
    first = first.scatter_reduce(0, seg, t, reduce="amin", include_self=True)
    first[-1:].copy_(total.reshape(1))
    cu = first.to(torch.int32)
    # Each packed row's padded place: its cloud's padded offset plus its
    # rank within the cloud.
    batch = torch.searchsorted(torch.cumsum(counts, 0), inverse, right=True)
    rb = batch.clamp_max(b - 1)
    dst = torch.where(batch < b, off[rb] + inverse - start[rb],
                      torch.zeros_like(inverse))
    return Layout(src=src, dst=dst, cu=cu, rows=total)


def _dense_segments(q, k, v, cu, patch: int, scale: float):
    """Attention inside each segment of cu, as a masked product over
    (segments, patch) slots; q, k, v: (A, H, D)."""
    a, h, d = q.shape
    s = cu.shape[0] - 1
    lo, hi = cu[:-1].long(), cu[1:].long()
    idx = lo[:, None] + torch.arange(patch, device=q.device)
    live = idx < hi[:, None]
    gidx = idx.clamp_max(a - 1)
    qs, ks, vs = (t[gidx].transpose(1, 2) for t in (q, k, v))  # (S,H,P,D)
    # Scores in float32 from the operands as they are, as the flash
    # kernel keeps them.
    logits = torch.matmul(qs.float(), ks.float().transpose(-1, -2)) * scale
    logits = logits.masked_fill(~live[:, None, None, :], -torch.inf)
    w = torch.softmax(logits, -1)
    w = torch.nan_to_num(w).to(vs.dtype)
    out = torch.matmul(w, vs).transpose(1, 2)                 # (S,P,H,D)
    into = torch.where(live, idx, torch.full_like(idx, a)).reshape(-1)
    res = q.new_zeros((a + 1, h, d))
    res.index_copy_(0, into, out.reshape(s * patch, h, d))
    return res[:a]


def flash_available(q: torch.Tensor) -> bool:
    return (q.is_cuda and q.dtype in (torch.float16, torch.bfloat16)
            and hasattr(torch.ops.aten, "_flash_attention_forward"))


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cu: torch.Tensor, patch: int) -> torch.Tensor:
    """(A, H, D) attention of q over k, v inside each segment of `cu`
    (every segment at most `patch` rows), softmax scale D ** -0.5."""
    scale = q.shape[-1] ** -0.5
    if flash_available(q):
        out = torch.ops.aten._flash_attention_forward(
            q, k, v, cu, cu, patch, patch, 0.0, False, False, scale=scale)
        return out[0]
    return _dense_segments(q, k, v, cu, patch, scale)
