"""The k nearest neighbours of every row of a packed level, within its own
cloud (Point Transformer V2's `pointops.knn_query`).

A level holds the rows of B clouds packed one cloud after another:
cloud b owns rows [offsets[b], offsets[b + 1]), and the rows past
offsets[B] are dummies (`batch` B).  For every real row r, `knn` gives
the K rows of its cloud nearest to it, the row itself included, sorted by
(distance, row), and -1 in the slots past the cloud's row count; a dummy
row gets -1 in every slot.  The distance is the float32 sum
(dx*dx + dy*dy) + dz*dz with d = xyz[candidate] - xyz[query], each
operation rounded on its own (no fused multiply-add), so the kernel's
sets and the plain version's are equal, not close.

A CPU tensor takes `knn_plain` (per cloud: the distances to every row of
the cloud, then a stable sort), a CUDA tensor the kernel
(`csrc/knn.cu`: each block stages its clouds' rows in shared memory and
keeps each query's K best in registers; K in `KNN_SIZES`), any other
device raises.  Each kernel call counts "knn" (`ops._launch`).
"""

from __future__ import annotations

import torch

from wireframe_tpu_torch.ops._launch import check, count, library, on_card, ptr

# The neighbour counts `csrc/knn.cu` is built for (held to it at load).
KNN_SIZES = (8, 16)
# Distances of one chunk of the plain search (queries x candidates).
PLAIN_PAIRS = 1 << 24


def sq_distances(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(Q, R) float32: (dx*dx + dy*dy) + dz*dz with d = c - q, each
    operation in its own rounding, for q (Q, 3) and c (R, 3)."""
    d = c[None, :, :] - q[:, None, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2]


def knn_plain(xyz: torch.Tensor, batch: torch.Tensor, offsets: torch.Tensor,
              k: int) -> torch.Tensor:
    """`knn` in PyTorch ops, a cloud and a chunk of its rows at a time;
    reads the offsets back to the host."""
    m = xyz.shape[0]
    out = torch.full((m, k), -1, dtype=torch.int64, device=xyz.device)
    bounds = offsets.tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        n = hi - lo
        if n <= 0:
            continue
        cand = xyz[lo:hi].float()
        step = max(1, PLAIN_PAIRS // n)
        for s in range(0, n, step):
            e = min(s + step, n)
            d = sq_distances(cand[s:e], cand)
            order = torch.sort(d, dim=1, stable=True).indices[:, :k]
            out[lo + s:lo + e, :order.shape[1]] = order + lo
    return out


def knn(xyz: torch.Tensor, batch: torch.Tensor, offsets: torch.Tensor,
        k: int) -> torch.Tensor:
    """(M, k) int64: the k nearest rows of each row of a packed level
    (module docstring).  xyz (M, 3) float32; batch (M,) int64, each row's
    cloud, B on dummy rows; offsets (B + 1,) int64, each cloud's first
    row and, last, the real rows' count."""
    if not on_card(xyz, "the kNN search"):
        return knn_plain(xyz, batch, offsets, k)
    return _launch(xyz, batch, offsets, k)


def _check_library(lib) -> None:
    built = tuple(s for s in (lib.knn_size(i) for i in range(3)) if s > 0)
    if built != KNN_SIZES:
        raise RuntimeError(f"csrc/knn.cu is built for K {built}; "
                           f"ops/knn.py says {KNN_SIZES}")


def _lib():
    return library("knn", {"knn": "PPPP" + "iii" + "P", "knn_size": "i"},
                   _check_library)


def _launch(xyz, batch, offsets, k):
    m, clouds = xyz.shape[0], offsets.shape[0] - 1
    if k not in KNN_SIZES:
        raise ValueError(f"the kNN kernel is built for k in {KNN_SIZES}, "
                         f"not {k}")
    if not 1 <= m < (1 << 31) - 1:
        raise ValueError(f"the kNN kernel takes 1 <= M < 2**31 - 1 rows; "
                         f"got {m}")
    if (xyz.shape != (m, 3) or batch.shape != (m,) or clouds < 1
            or offsets.dim() != 1):
        raise ValueError(f"xyz (M, 3), batch (M,), offsets (B + 1,) for "
                         f"M = {m}; got {tuple(xyz.shape)}, "
                         f"{tuple(batch.shape)}, {tuple(offsets.shape)}")
    if (xyz.dtype, batch.dtype, offsets.dtype) != (
            torch.float32, torch.int64, torch.int64):
        raise ValueError("xyz float32, batch and offsets int64")
    if any(t.device != xyz.device for t in (batch, offsets)):
        raise ValueError("the kNN search's tensors must lie on one device")
    out = torch.empty((m, k), dtype=torch.int64, device=xyz.device)
    args = [t.contiguous() for t in (xyz, batch, offsets)]
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    check(_lib().knn(*map(ptr, args), ptr(out), m, clouds, k, stream), "knn")
    count("knn")
    return out
