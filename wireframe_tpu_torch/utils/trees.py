"""Small tree utilities.

Port of `wireframe_tpu/utils/trees.py`.  A tree here is what the port
keeps parameters in: a state_dict, a nested dict of tensors (or of numpy
arrays, as the flax bridge holds them), a `TrainState`'s params, or
lists and tuples of those.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def tree_size_bytes(tree) -> int:
    """Total bytes of the tensors and arrays at the leaves of `tree`."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, Mapping):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    if tree is None:
        return 0
    raise TypeError(f"tree_size_bytes: leaf of type {type(tree).__name__}")
