"""Sharding arithmetic across processes, and the global batch and state.

Port of `wireframe_tpu/parallel/multihost.py`.  `host_shard_indices` and
`host_batch_slice` are its arithmetic, with the process index and count
taken from the default process group (`parallel.mesh.world`) instead of
`jax.process_index()` / `jax.process_count()`.  `assemble_global_batch`
is the inverse of `parallel.mesh.local_rows` (the JAX function builds one
global array from every host's rows; here every rank gets the rows of
every rank), and `replicate_across_hosts` broadcasts rank 0's values and
then checks that every rank held them already.  Without a process group
each is the identity.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from wireframe_tpu_torch.parallel.collective_audit import (
    all_gather,
    all_reduce,
)
from wireframe_tpu_torch.parallel.mesh import (
    broadcast_params,
    param_tensors,
    world,
)

# The keys `parallel.mesh.local_rows` splits: the batch layout
# (wireframe_tpu/parallel/mesh.py:batch_sharding).
BATCH_LAYOUT = ("point_clouds", "target_vertices", "vertex_existence",
                "vertex_counts", "edge_labels")


def host_shard_indices(num_items: int, process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> List[int]:
    """Round-robin split of dataset indices across processes: per-process
    counts stay within one of each other for any corpus order."""
    rank, size = world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return list(range(pi, num_items, pc))


def host_batch_slice(global_batch: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> int:
    """Per-process batch size of an evenly divisible global batch."""
    pc = world()[1] if process_count is None else process_count
    if global_batch % pc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {pc} hosts")
    return global_batch // pc


def assemble_global_batch(local_batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """The global batch from every rank's `local_rows`, in rank order.

    Every key must be in the batch layout (ADVICE r2): a value outside
    it is not split by rows, so gathering it would silently stack
    whatever each rank held; replicate such values with
    `replicate_across_hosts`.  NCCL gathers CUDA tensors; gloo gathers
    CPU tensors only.
    """
    extra = sorted(set(local_batch) - set(BATCH_LAYOUT))
    if extra:
        raise ValueError(
            f"assemble_global_batch: keys {extra} are not in the batch "
            "sharding layout; replicate host-identical values via "
            "replicate_across_hosts instead")
    return {k: all_gather(v) for k, v in local_batch.items()}


def replicate_across_hosts(model_or_tree):
    """Rank 0's values of a module's parameters and buffers (or of a
    {name: tensor} dict) on every rank, in place, after checking that
    every rank held exactly those values: ranks that built their state
    from one seed or one checkpoint agree, and a rank that did not (a
    different config, another checkpoint) raises on every rank.
    Returns its argument."""
    before = [t.detach().clone() for t in param_tensors(model_or_tree)]
    broadcast_params(model_or_tree)
    differ = sum(int(not torch.equal(a, b))
                 for a, b in zip(before, param_tensors(model_or_tree)))
    flag = torch.tensor([float(differ)], device=(
        before[0].device if before else "cpu"))
    all_reduce(flag, "max")
    if flag.item():
        raise ValueError(
            "replicate_across_hosts: a rank held values that differ from "
            f"rank 0's ({differ} tensors on rank {world()[0]}); every "
            "rank must build its state from the same seed or checkpoint")
    return model_or_tree
