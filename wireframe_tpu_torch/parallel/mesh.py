"""Process-group layout: the port's counterpart of the device mesh.

Port of `wireframe_tpu/parallel/mesh.py`.  The JAX package declares a
(dp, mp) `Mesh` and lets GSPMD partition one jitted program over it.
PyTorch has no partitioner, so the port runs one process per GPU,
started by `torchrun` (`python -m torch.distributed.run`):

- `init_distributed` joins the process group `torchrun` describes in the
  environment (NCCL for CUDA, gloo for the CPU);
- `resolve_layout` applies `resolve_mesh`'s rules to the group's world
  size (with `train=True`, also the training layout's own rules);
- `Layout` places this rank on the (dp, mp) grid as the JAX mesh's
  `devices[:dp * mp].reshape(dp, mp)` does: world rank r sits at dp
  index r // mp and mp index r % mp, and the layout holds the process
  groups of its dp column and its mp row;
- each rank takes the contiguous block of the global batch's rows of its
  dp index (`local_rows`), as `P("dp")` splits the batch axis; the ranks
  of one mp group take the same rows and split the point axis in the
  encoder (`models.encoder`), as `P("dp", "mp", None)` splits it;
- `broadcast_params` replicates parameters from rank 0, the counterpart
  of `replicate`.

One divergence from `resolve_mesh`: where `parallel.dp=-1` finds no
data-parallel width above 1 that divides the batch on a group of more
than one rank, the JAX package logs a warning and trains on one device;
a `torchrun` rank cannot sit out a step, so `resolve_layout` raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from wireframe_tpu_torch.parallel.collective_audit import broadcast
from wireframe_tpu_torch.utils.platform import resolve_device


def resolve_layout(cfg, world_size: int,
                   batch_size: Optional[int] = None, train: bool = False
                   ) -> Optional[Tuple[int, int]]:
    """(dp, mp) of `cfg.parallel` over `world_size` ranks, or None for
    1 x 1.

    `resolve_mesh`'s rules: explicit dp / mp that do not fit the ranks,
    the global batch (`batch_size`, default `train.batch_size`) or
    `data.num_points` raise; dp = -1 takes the largest width up to
    world_size // mp that divides the batch.  Where that is 1 on more
    than one rank, this raises (module docstring).

    train: the training layout's rules on top.  Every rank takes part in
    every step, so dp x mp must be the world size.  With mp > 1 each rank
    runs the encoder on N / mp points, and the path is decided on the
    whole cloud's N as the JAX module decides it (models/encoder.py:
    141-150): where the training chain takes N, N / mp must be a multiple
    of the chain's tile too, since a slice never falls back to the plain
    chain; and with the query head's decoder_kv_pool > 1, a multiple of
    the pool, so that no KV window straddles two ranks.
    """
    n = world_size
    dp, mp = cfg.parallel.dp, cfg.parallel.mp
    bs = cfg.train.batch_size if batch_size is None else batch_size
    npts = cfg.data.num_points
    if mp < 1 or dp < -1 or dp == 0:
        raise ValueError(f"bad parallel config dp={dp} mp={mp}")
    if mp > n:
        raise ValueError(f"parallel.mp={mp} exceeds {n} devices")
    if mp > 1 and npts % mp != 0:
        raise ValueError(
            f"data.num_points={npts} not divisible by parallel.mp={mp}")
    if dp == -1:
        cap = n // mp
        dp = max(d for d in range(1, cap + 1) if bs % d == 0)
        if dp * mp == 1 and n > 1:
            raise ValueError(
                f"parallel.dp=-1 found no data-parallel width in 2..{cap} "
                f"that divides train.batch_size={bs} on {n} ranks, and a "
                "rank cannot sit out a step; set parallel.dp explicitly "
                "or pick a divisible batch size")
    else:
        if dp * mp > n:
            raise ValueError(
                f"mesh dp={dp} x mp={mp} needs {dp * mp} devices, have {n}")
        if bs % dp != 0:
            raise ValueError(
                f"train.batch_size={bs} not divisible by parallel.dp={dp}")
    if train:
        _check_train_layout(cfg, world_size, dp, mp)
    if dp * mp == 1:
        return None
    return dp, mp


def _check_train_layout(cfg, world_size: int, dp: int, mp: int) -> None:
    if dp * mp != world_size:
        raise ValueError(
            f"parallel.dp={cfg.parallel.dp} parallel.mp={mp} resolves to "
            f"dp={dp} x mp={mp} = {dp * mp} ranks on a group of "
            f"{world_size}; every rank takes part in every step, so dp x mp "
            "must be the world size")
    if mp == 1:
        return
    m = cfg.model
    n = cfg.data.num_points
    tile = m.pallas_chain_tile or m.pallas_tile
    if m.use_pallas_encoder and n % tile == 0 and (n // mp) % tile:
        raise ValueError(
            f"data.num_points={n} over parallel.mp={mp} leaves {n // mp} "
            f"points a rank, not a multiple of the training chain's tile "
            f"{tile} (model.pallas_chain_tile); a slice does not fall back "
            "to the plain chain")
    if m.vertex_head == "query" and m.decoder_kv_pool > 1 and (
            (n // mp) % m.decoder_kv_pool):
        raise ValueError(
            f"data.num_points={n} over parallel.mp={mp} leaves {n // mp} "
            f"points a rank, not a multiple of model.decoder_kv_pool="
            f"{m.decoder_kv_pool}: a KV window would straddle two ranks")


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init_distributed(backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Join the process group `torchrun` describes in the environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and
    return the device this rank runs on.

    device: as `utils.platform.resolve_device` takes it; "cuda" (the
    default) becomes `cuda:LOCAL_RANK`, an explicit index is kept (two
    ranks may share one card that way, over gloo).  backend: NCCL for a
    CUDA device, gloo for the CPU, unless given; gloo also carries CUDA
    tensors for all_reduce and broadcast.  A failed init raises: there is
    no fallback to another backend or device.  Without `WORLD_SIZE` in
    the environment, or in a process already in a group, no group is
    joined and only the device is resolved.
    """
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            **kwargs)
    return dev


def local_rows(batch: Dict, rank: int, dp: int) -> Dict:
    """This rank's contiguous block of every array's rows: rows
    rank * B / dp .. (rank + 1) * B / dp of B."""
    out = {}
    for k, v in batch.items():
        b = len(v)
        if b % dp:
            raise ValueError(f"{k}: {b} rows do not split over dp={dp}")
        m = b // dp
        out[k] = v[rank * m:(rank + 1) * m]
    return out


@dataclass(frozen=True)
class Layout:
    """This rank's place on the (dp, mp) grid of the default process
    group, and the groups it reduces over: `dp_group`, the dp ranks of
    its mp index (the batch's other row blocks), and `mp_group`, the mp
    ranks of its dp index (the same rows' other point slices).  A group
    that spans the world is None, the default group."""

    dp_rank: int
    dp: int
    mp_rank: int = 0
    mp: int = 1
    dp_group: object = None
    mp_group: object = None

    @classmethod
    def of_group(cls, mp: int = 1) -> "Layout":
        """The layout of the default group's ranks as dp = world / mp rows
        of mp.  Every rank must call it (it makes the groups, in one
        order on every rank)."""
        rank, size = world()
        if size % mp:
            raise ValueError(f"parallel.mp={mp} does not divide {size} ranks")
        dp = size // mp
        groups = {}
        for axis, members in (
                ("dp", [[d * mp + m for d in range(dp)] for m in range(mp)]),
                ("mp", [[d * mp + m for m in range(mp)] for d in range(dp)])):
            for ranks in members:
                if len(ranks) == size:
                    group = None
                else:
                    group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
        return cls(rank // mp, dp, rank % mp, mp, groups["dp"],
                   groups["mp"])

    @property
    def main(self) -> bool:
        """World rank 0: the rank that logs and writes."""
        return self.dp_rank == 0 and self.mp_rank == 0

    def rows(self, local_batch: int) -> Tuple[int, int]:
        """(first row, global batch) of this rank's rows."""
        return self.dp_rank * local_batch, self.dp * local_batch


def param_tensors(model_or_tree) -> list:
    """A module's parameters and buffers, or a dict's values, in order."""
    if isinstance(model_or_tree, torch.nn.Module):
        return (list(model_or_tree.parameters())
                + list(model_or_tree.buffers()))
    return list(model_or_tree.values())


def flat_apply(tensors, fn) -> None:
    """Pack `tensors` into one flat buffer per dtype (in their order),
    apply `fn` (in place) to each buffer, and unpack into the tensors."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        fn(flat)
        off = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def broadcast_params(model_or_tree):
    """Rank 0's values of a module's parameters and buffers, or of a
    {name: tensor} dict, on every rank, in place; returns its argument."""
    flat_apply(param_tensors(model_or_tree), broadcast)
    return model_or_tree
