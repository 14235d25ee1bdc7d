"""K4's plain version and the port's matcher against the JAX package.

The plain version is a line-for-line copy of the JAX lockstep body, so
the assignments must be EQUAL (array_equal, ties included) to
`solve_lsa_rows_lockstep` and to the Pallas kernel in interpret mode, on
random costs, quantized costs full of ties, samples with fewer active
rows than R, and a NaN row after the loss's clamp.  Costs are checked
optimal against scipy to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from wireframe_tpu.ops.pallas_lsa import (
    max_safe_cost as jax_max_safe_cost,
    solve_lsa_rows_lockstep,
    solve_lsa_rows_pallas,
)
from wireframe_tpu_torch.ops.lockstep_lsa import (
    max_safe_cost,
    solve_lsa_rows,
    solve_lsa_rows_lockstep_plain,
)
from wireframe_tpu_torch.ops.lsa import assignment_cost, solve_square
from wireframe_tpu_torch.ops.matcher import WireframeMatcher


def _costs(kind, shape, seed):
    b, r, c = shape
    rng = np.random.default_rng(seed)
    if kind == "ties":
        cost = rng.integers(0, 4, size=shape) * 0.5
    else:
        cost = rng.random(shape) * 10
    cost = cost.astype(np.float32)
    nr = rng.integers(0, r + 1, size=b).astype(np.int32)
    if kind in ("random", "ties"):
        nr[:] = r
    nr[0] = min(nr[0], r)
    if kind == "nan_clamped":
        cost[1, 2, :] = np.nan
        cost[2, 0, 3] = 1e12
        ceil = max_safe_cost()
        assert ceil == jax_max_safe_cost()
        cost = np.where(np.isnan(cost), ceil,
                        np.minimum(cost, ceil)).astype(np.float32)
        nr[1:3] = r
    return cost, nr


def _check_optimal(cost, nr, got):
    for i in range(cost.shape[0]):
        k = int(nr[i])
        assert (got[i, k:] == -1).all()
        if k == 0:
            continue
        g = got[i, :k]
        assert len(set(g.tolist())) == k
        ri, ci = linear_sum_assignment(cost[i, :k])
        np.testing.assert_allclose(cost[i, np.arange(k), g].sum(),
                                   cost[i, ri, ci].sum(), rtol=1e-5)


@pytest.mark.parametrize("kind,shape,seed", [
    ("random", (8, 40, 40), 0),      # the recipe's V=40 problem
    ("ties", (8, 12, 16), 1),
    ("partial_rows", (8, 40, 40), 2),
    ("partial_rows", (6, 12, 30), 3),
    ("nan_clamped", (4, 10, 12), 4),
])
def test_plain_equals_jax_lockstep(kind, shape, seed):
    cost, nr = _costs(kind, shape, seed)
    want = np.asarray(solve_lsa_rows_lockstep(jnp.asarray(cost),
                                              jnp.asarray(nr)))
    got = solve_lsa_rows_lockstep_plain(torch.from_numpy(cost),
                                        torch.from_numpy(nr)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind != "nan_clamped":
        _check_optimal(cost, nr, got)


@pytest.mark.parametrize("kind", ["random", "ties", "partial_rows",
                                  "nan_clamped"])
def test_plain_equals_pallas_interpret(kind):
    cost, nr = _costs(kind, (4, 10, 12), 11)
    want = np.asarray(solve_lsa_rows_pallas(jnp.asarray(cost),
                                            jnp.asarray(nr),
                                            interpret=True))
    got = solve_lsa_rows(torch.from_numpy(cost), torch.from_numpy(nr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_takes_plain_on_cpu_without_counting():
    cost, nr = _costs("random", (3, 6, 8), 5)
    before = solve_lsa_rows.launches
    got = solve_lsa_rows(torch.from_numpy(cost), torch.from_numpy(nr))
    assert solve_lsa_rows.launches == before
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    with pytest.raises(ValueError, match="rows <= cols"):
        solve_lsa_rows(torch.zeros(1, 5, 4), torch.ones(1, dtype=torch.int32))


def test_square_solvers_and_assignment_cost():
    rng = np.random.default_rng(6)
    cost = torch.from_numpy((rng.random((5, 9, 9)) * 3).astype(np.float32))
    a = solve_square(cost, "auto")
    s = solve_square(cost, "scipy")
    np.testing.assert_allclose(assignment_cost(cost, a).numpy(),
                               assignment_cost(cost, s).numpy(), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A9"):
        solve_square(cost, "device")


def test_matcher_matches_scipy_optimum():
    rng = np.random.default_rng(8)
    b, v = 4, 8
    pv = torch.from_numpy(rng.normal(size=(b, v, 3)).astype(np.float32))
    pe = torch.from_numpy(rng.random((b, v)).astype(np.float32))
    counts = torch.tensor([3, 8, 0, 5], dtype=torch.int32)
    tv = torch.from_numpy((rng.normal(size=(b, v, 3))
                           * (np.arange(v)[None, :, None]
                              < counts.numpy()[:, None, None]))
                          .astype(np.float32))
    col, matched = WireframeMatcher("auto")(pv, pe, tv, counts)
    col_s, matched_s = WireframeMatcher("scipy")(pv, pe, tv, counts)
    from wireframe_tpu_torch.losses.wireframe_loss import matching_cost_matrix

    cost = matching_cost_matrix(pv, pe, tv, counts)
    np.testing.assert_allclose(assignment_cost(cost, col).numpy(),
                               assignment_cost(cost, col_s).numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(matched.sum(1).numpy(),
                                  counts.numpy())
    with pytest.raises(NotImplementedError, match="A9"):
        WireframeMatcher("device")(pv, pe, tv, counts)
