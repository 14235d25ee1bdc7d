"""The port's `ops/adjacency.py` against `wireframe_tpu/ops/adjacency.py`.

Tolerance: none.  The same (B, E) probabilities give `array_equal`
adjacency matrices and pair values, for V in 4, 40 and 64 at several
thresholds, including probabilities that sit exactly on the threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.ops import adjacency as jax_adj
from wireframe_tpu_torch.ops import adjacency as port_adj
from wireframe_tpu_torch.ops.pairs import num_pairs


@pytest.mark.parametrize("v", [4, 40, 64])
@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.5, 0.9])
def test_adjacency_matches_jax(v, threshold):
    rng = np.random.default_rng(v)
    probs = rng.random((3, num_pairs(v))).astype(np.float32)
    probs[:, ::7] = np.float32(threshold)       # ties: not above
    want = np.asarray(jax_adj.adjacency_from_edge_probs(
        jnp.asarray(probs), v, threshold))
    got = port_adj.adjacency_from_edge_probs(
        torch.from_numpy(probs), v, threshold)
    assert got.dtype == torch.float32 and got.shape == (3, v, v)
    np.testing.assert_array_equal(got.numpy(), want)

    back_want = np.asarray(jax_adj.edge_probs_from_adjacency(
        jnp.asarray(want)))
    back = port_adj.edge_probs_from_adjacency(got)
    np.testing.assert_array_equal(back.numpy(), back_want)
    np.testing.assert_array_equal(back.numpy(),
                                  (probs > threshold).astype(np.float32))


def test_adjacency_is_symmetric_with_an_empty_diagonal():
    v = 12
    probs = torch.from_numpy((np.random.default_rng(1).random(
        (2, num_pairs(v))) > 0.6).astype(np.float32))
    adj = port_adj.adjacency_from_edge_probs(probs, v)
    assert torch.equal(adj, adj.transpose(1, 2))
    assert not adj.diagonal(dim1=1, dim2=2).any()


def test_edge_probs_from_adjacency_reads_any_values():
    # The inverse reads the upper triangle of any (B, V, V) array, as the
    # JAX function does, not only 0/1 adjacency.
    v = 6
    adj = np.random.default_rng(2).random((2, v, v)).astype(np.float32)
    np.testing.assert_array_equal(
        port_adj.edge_probs_from_adjacency(torch.from_numpy(adj)).numpy(),
        np.asarray(jax_adj.edge_probs_from_adjacency(jnp.asarray(adj))))
