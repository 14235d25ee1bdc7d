"""The port's Building3D metrics against the JAX package's.

- `hausdorff_distance_line` (numpy, float64) is `array_equal` to JAX's.
- The torch twin is within 1e-6 relative of `hausdorff_distance_line_jax`
  (both float32; XLA may fuse the sampling's multiply-add), its linspace
  table equals `jnp.linspace`'s, and an entry does not depend on the
  padding or the batch around it (`array_equal`), which the pipelined
  eval's bit-equality rests on.
- `APCalculator` counters and summaries are equal (exact) on the same
  predictions: with edges, the corners-only fallback, the live-corner
  filter's corner set, precomputed device distances, and merge_counters.
- WED, its helpers and the RMSEs are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.config import Config as JaxConfig
from wireframe_tpu.data.building3d import edge_endpoint_array as jax_ev
from wireframe_tpu.eval.distributed import (
    batched_edge_distances as jax_batched_distances,
)
from wireframe_tpu.eval.evaluator import _corner_set as jax_corner_set
from wireframe_tpu.metrics import ap_calculator as jax_ap
from wireframe_tpu.metrics import hausdorff as jax_hd
from wireframe_tpu.metrics import rmse as jax_rmse
from wireframe_tpu.metrics import wed as jax_wed
from wireframe_tpu_torch.config import Config
from wireframe_tpu_torch.data.building3d import edge_endpoint_array
from wireframe_tpu_torch.eval.distributed import batched_edge_distances
from wireframe_tpu_torch.eval.evaluator import _corner_set
from wireframe_tpu_torch.metrics import ap_calculator, hausdorff, rmse, wed


def _lines(rng, n):
    return rng.normal(size=(n, 2, 3)) * 3.0


def test_numpy_hausdorff_is_identical():
    rng = np.random.default_rng(0)
    p, t = _lines(rng, 7), _lines(rng, 5)
    np.testing.assert_array_equal(hausdorff.hausdorff_distance_line(p, t),
                                  jax_hd.hausdorff_distance_line(p, t))
    assert hausdorff.hausdorff_distance_line(p[:0], t).size == 0


@pytest.mark.parametrize("s", [2, 5, 20, 33])
def test_linspace_table_equals_jax(s):
    want = np.asarray(jnp.linspace(0.0, 1.0, s))
    got = hausdorff.linspace_f32(s)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_torch_twin_matches_jax_and_ignores_padding():
    rng = np.random.default_rng(1)
    p = _lines(rng, 9).astype(np.float32)
    t = _lines(rng, 6).astype(np.float32)
    got = hausdorff.hausdorff_distance_line_torch(
        torch.from_numpy(p), torch.from_numpy(t)).numpy()
    want = np.asarray(jax_hd.hausdorff_distance_line_jax(
        jnp.asarray(p), jnp.asarray(t)))
    assert got.dtype == np.float32 and got.shape == (9, 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # Padded into a batch of two, beside another sample: the same bits.
    pp = np.zeros((2, 16, 2, 3), np.float32)
    tt = np.zeros((2, 8, 2, 3), np.float32)
    pp[0, :9], tt[0, :6] = p, t
    pp[1], tt[1] = _lines(rng, 16), _lines(rng, 8)
    batched = hausdorff.hausdorff_distance_line_torch(
        torch.from_numpy(pp), torch.from_numpy(tt)).numpy()
    np.testing.assert_array_equal(batched[0, :9, :6], got)


def test_batched_edge_distances_match_jax():
    rng = np.random.default_rng(2)
    preds = [_lines(rng, 5), np.empty((0, 2, 3)), _lines(rng, 11)]
    gts = [_lines(rng, 4), _lines(rng, 3), _lines(rng, 9)]
    got = batched_edge_distances(preds, gts, device="cpu")
    want = jax_batched_distances(preds, gts)
    assert got[1] is None and want[1] is None
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == np.float64 and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def _sample(rng, n_gt=8, n_pred=10, n_edges=6, near=True):
    """A GT wireframe and a prediction whose slots sit near (or far from)
    the GT corners, with `n_edges` predicted edges."""
    gt_v = rng.normal(size=(n_gt, 3)).astype(np.float32) * 2
    gt_e = np.array(sorted({tuple(sorted(rng.choice(n_gt, 2, replace=False)))
                            for _ in range(n_gt + 2)}), np.int64)
    pv = np.concatenate([gt_v[rng.permutation(n_gt)] + (
        rng.normal(size=(n_gt, 3)) * (0.05 if near else 2.0)),
        rng.normal(size=(n_pred - n_gt, 3)) * 2]).astype(np.float32)
    pe = np.array(sorted({tuple(sorted(rng.choice(n_pred, 2, replace=False)))
                          for _ in range(n_edges)}), np.int64).reshape(-1, 2)
    return pv, pe, gt_v, gt_e


def _ap_batch(samples, ev):
    batch = {k: [] for k in ("predicted_vertices", "predicted_edges",
                             "pred_edges_vertices", "wf_vertices", "wf_edges",
                             "wf_edges_vertices")}
    for pv, pe, gv, ge in samples:
        batch["predicted_vertices"].append(pv)
        batch["predicted_edges"].append(pe)
        batch["pred_edges_vertices"].append(ev(np.asarray(pv, np.float64),
                                               pe))
        batch["wf_vertices"].append(gv)
        batch["wf_edges"].append(ge)
        batch["wf_edges_vertices"].append(ev(np.asarray(gv, np.float64), ge))
    return batch


def _both(batches, thresh=1.0):
    mine = ap_calculator.APCalculator(distance_thresh=thresh)
    theirs = jax_ap.APCalculator(distance_thresh=thresh)
    for b in batches:
        mine.compute_metrics(_ap_batch(b, edge_endpoint_array))
        theirs.compute_metrics(_ap_batch(b, jax_ev))
    return mine, theirs


def _assert_same(mine, theirs):
    assert mine.num_samples == theirs.num_samples
    assert mine.ap_dict == theirs.ap_dict
    assert mine.summarize() == theirs.summarize()


@pytest.mark.parametrize("case", ["edges", "corners only", "far"])
def test_ap_counters_equal(case):
    rng = np.random.default_rng({"edges": 3, "corners only": 4,
                                 "far": 5}[case])
    n_edges = 0 if case == "corners only" else 7
    samples = [_sample(rng, n_edges=n_edges, near=case != "far")
               for _ in range(4)]
    mine, theirs = _both([samples[:3], samples[3:]])
    _assert_same(mine, theirs)
    if case == "edges":
        assert mine.ap_dict["tp_edges"] > 0 and mine.ap_dict["tp_corners"] > 0
    if case == "corners only":
        assert mine.ap_dict["tp_fp_edges"] == 0 and mine.ap_dict["wed"] == 4


def test_ap_counters_equal_with_device_distances_and_live_corners():
    """Precomputed (device) distances and the live-corner filter's corner
    set: the same counters in both packages."""
    rng = np.random.default_rng(6)
    samples = [_sample(rng, n_edges=6) for _ in range(3)]
    live = [rng.random(10) > 0.3 for _ in samples]
    cfg, jcfg = Config(), JaxConfig()
    cfg.eval.live_corner_filter = jcfg.eval.live_corner_filter = True
    batches = []
    for ev, corner_set, c, dist in ((edge_endpoint_array, _corner_set, cfg,
                                     batched_edge_distances),
                                    (jax_ev, jax_corner_set, jcfg,
                                     jax_batched_distances)):
        # Edges index the full slot set (the evaluator decodes before it
        # filters the corners); only the corner set is filtered.
        b = _ap_batch(samples, ev)
        b["predicted_vertices"] = [corner_set(c, s[0], lv)
                                   for s, lv in zip(samples, live)]
        kw = {"device": "cpu"} if dist is batched_edge_distances else {}
        b["edge_distance"] = dist(b["pred_edges_vertices"],
                                  b["wf_edges_vertices"], **kw)
        batches.append(b)
    np.testing.assert_array_equal(batches[0]["predicted_vertices"][0],
                                  samples[0][0][live[0]])
    mine = ap_calculator.APCalculator(distance_thresh=1.0)
    theirs = jax_ap.APCalculator(distance_thresh=1.0)
    mine.compute_metrics(batches[0])
    theirs.compute_metrics(batches[1])
    _assert_same(mine, theirs)


def test_merge_counters_equal():
    rng = np.random.default_rng(7)
    samples = [_sample(rng, n_edges=5) for _ in range(4)]
    parts = [_both([[s]]) for s in samples]
    mine = parts[0][0].merge_counters([p[0] for p in parts[1:]])
    theirs = parts[0][1].merge_counters([p[1] for p in parts[1:]])
    _assert_same(mine, theirs)
    whole, _ = _both([samples])
    assert mine.num_samples == whole.num_samples == 4
    for k in ap_calculator._COUNTER_KEYS:
        np.testing.assert_allclose(mine.ap_dict[k], whole.ap_dict[k],
                                   rtol=1e-12, err_msg=k)


def test_wed_and_helpers_equal():
    rng = np.random.default_rng(8)
    for _ in range(5):
        pv, pe, gv, ge = _sample(rng, n_edges=6)
        assert wed.graph_edit_distance(pv, pe, gv, ge, 0.3) == \
            jax_wed.graph_edit_distance(pv, pe, gv, ge, 0.3)
        gev = edge_endpoint_array(np.asarray(gv, np.float64), ge)
        np.testing.assert_array_equal(
            wed.compute_edge_indices(gev, np.unique(gev.reshape(-1, 3),
                                                    axis=0)),
            jax_wed.compute_edge_indices(gev, np.unique(gev.reshape(-1, 3),
                                                        axis=0)))
        np.testing.assert_array_equal(wed.setdiff_rows(pv, gv[:4]),
                                      jax_wed.setdiff_rows(pv, gv[:4]))
    assert wed.graph_edit_distance(np.empty((0, 3)), np.empty((0, 2)), gv,
                                   ge, 0.0) == jax_wed.graph_edit_distance(
        np.empty((0, 3)), np.empty((0, 2)), gv, ge, 0.0)


def test_rmse_equal():
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(7, 3)), rng.normal(size=(5, 3))
    for fn, jfn in ((rmse.hungarian_rmse, jax_rmse.hungarian_rmse),
                    (rmse.aligned_rmse, jax_rmse.aligned_rmse)):
        assert fn(a, b) == jfn(a, b)
        assert fn(a[:0], b[:0]) == jfn(a[:0], b[:0])
    assert rmse.hungarian_rmse(a[:0], b) == jax_rmse.hungarian_rmse(a[:0], b)
