"""The port's wireframe loss against the JAX package's.

Same numpy predictions and targets into `wireframe_loss(matcher="pallas")`
(the lockstep kernel in interpret mode on the CPU) and into the port's
loss (K4's plain version on the CPU), in all four label modes.  The
matching must be EQUAL (same tie rule); the losses agree to f32 noise
(rtol 1e-5), and so do their gradients with respect to the predictions
(rtol 1e-4, atol 1e-6: the gradients are sums of a few f32 terms).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.losses.wireframe_loss import (
    WireframeLossConfig as JaxLossConfig,
    wireframe_loss as jax_wireframe_loss,
)
from wireframe_tpu_torch.losses.wireframe_loss import (
    WireframeLossConfig,
    wireframe_loss,
)
from wireframe_tpu_torch.ops.pairs import triu_pairs_np

V = 8
E = V * (V - 1) // 2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    b = 4
    counts = np.array([3, 8, 0, 5], np.int32)
    live = np.arange(V)[None, :] < counts[:, None]
    pred = {
        "vertices": rng.normal(size=(b, V, 3)).astype(np.float32),
        "existence_logits": rng.normal(size=(b, V)).astype(np.float32) * 2,
        "edge_logits": rng.normal(size=(b, E)).astype(np.float32),
    }
    # Two slots predicting the same point make exact cost ties.
    pred["vertices"][1, 5] = pred["vertices"][1, 2]
    pred["existence_logits"][1, 5] = pred["existence_logits"][1, 2]
    slot_live = rng.random((b, V)) > 0.3
    pairs = triu_pairs_np(V)
    pred["pair_mask"] = slot_live[:, pairs[:, 0]] & slot_live[:, pairs[:, 1]]
    tgt = {
        "vertices": (rng.normal(size=(b, V, 3)) * live[..., None]).astype(
            np.float32),
        "vertex_existence": live.astype(np.float32),
        "edge_labels": (rng.random((b, E)) < 0.3).astype(np.float32),
        "vertex_counts": counts,
    }
    return pred, tgt


def _jax_loss(pred, tgt, cfg):
    def f(v, logits, edge_logits):
        p = {"vertices": v, "existence_logits": logits,
             "existence_probabilities": jax.nn.sigmoid(logits),
             "edge_logits": edge_logits,
             "pair_mask": jnp.asarray(pred["pair_mask"])}
        out = jax_wireframe_loss(p, {k: jnp.asarray(x)
                                     for k, x in tgt.items()}, cfg)
        return out["total_loss"], out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(pred["vertices"]), jnp.asarray(pred["existence_logits"]),
        jnp.asarray(pred["edge_logits"]))
    return out, grads


def _torch_loss(pred, tgt, cfg):
    v = torch.tensor(pred["vertices"], requires_grad=True)
    logits = torch.tensor(pred["existence_logits"], requires_grad=True)
    edge_logits = torch.tensor(pred["edge_logits"], requires_grad=True)
    p = {"vertices": v, "existence_logits": logits,
         "existence_probabilities": torch.sigmoid(logits),
         "edge_logits": edge_logits,
         "pair_mask": torch.from_numpy(pred["pair_mask"])}
    out = wireframe_loss(p, {k: torch.from_numpy(x) for k, x in tgt.items()},
                         cfg)
    grads = torch.autograd.grad(out["total_loss"], (v, logits, edge_logits))
    return out, grads


@pytest.mark.parametrize("matched_edge,matched_exist",
                         list(itertools.product([False, True], repeat=2)))
def test_loss_matches_jax_pallas_matcher(matched_edge, matched_exist):
    pred, tgt = _inputs(0)
    kw = dict(matched_edge_labels=matched_edge,
              matched_existence_labels=matched_exist)
    want, want_g = _jax_loss(pred, tgt, JaxLossConfig(matcher="pallas", **kw))
    got, got_g = _torch_loss(pred, tgt, WireframeLossConfig(matcher="auto",
                                                            **kw))
    np.testing.assert_array_equal(got["matched_cols"].numpy(),
                                  np.asarray(want["matched_cols"]))
    for key in ("total_loss", "vertex_loss", "existence_loss", "edge_loss"):
        np.testing.assert_allclose(float(got[key].detach()), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    for key in ("edge_labels_eff", "pair_mask_eff"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_scipy_matcher_and_degenerate_batches():
    """matcher="scipy" solves the square problem on the host: the same
    loss as the JAX scipy path.  A batch with no targets gives zero
    vertex and edge losses, as the JAX guards do."""
    pred, tgt = _inputs(1)
    want, _ = _jax_loss(pred, tgt, JaxLossConfig(matcher="scipy"))
    got, _ = _torch_loss(pred, tgt, WireframeLossConfig(matcher="scipy"))
    np.testing.assert_allclose(float(got["total_loss"].detach()),
                               float(want["total_loss"]), rtol=1e-5)
    empty = dict(tgt, vertex_counts=np.zeros(4, np.int32),
                 vertices=np.zeros_like(tgt["vertices"]))
    got, _ = _torch_loss(pred, empty, WireframeLossConfig())
    assert float(got["vertex_loss"]) == 0.0 and float(got["edge_loss"]) == 0.0


def test_nan_prediction_is_clamped_before_the_solver():
    """A NaN vertex maps its cost row to the ceiling; both packages then
    solve the same problem."""
    pred, tgt = _inputs(2)
    pred["vertices"][1, 4] = np.nan
    want, _ = _jax_loss(pred, tgt, JaxLossConfig(matcher="pallas"))
    got, _ = _torch_loss(pred, tgt, WireframeLossConfig(matcher="pallas"))
    np.testing.assert_array_equal(got["matched_cols"].numpy(),
                                  np.asarray(want["matched_cols"]))


def test_device_matcher_raises():
    pred, tgt = _inputs(3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A9"):
        _torch_loss(pred, tgt, WireframeLossConfig(matcher="device"))
