"""Three train steps of the port against the JAX package's make_train_step.

The recipe at small width (`configs/recommended.yaml`: query decoder,
existence slot masks, slot features, kv_pool 4 through the stash chain,
matched edge and existence labels, EMA 0.999), in f32, from the same
flax-initialized weights (carried over by the bridge, with randomized
biases and slot queries), on the same `make_random_batch` arrays.  The
JAX side runs its Pallas kernels in interpret mode with
`train.matcher=pallas`, so both sides use the lockstep tie rule.  Dropout
is 0 and the device augmentation off: both draw from different random
streams.

Tolerances, each with its reason:
- step-0 losses and metrics: rtol 1e-5 (same f32 arithmetic, other
  summation orders);
- later losses: rtol 1e-4 (after an update the params differ, below);
- params and EMA: |diff| <= 2 * (sum of the learning rates applied) +
  1e-6.  Adam normalizes each update to about lr, so where a gradient is
  near 0 its sign, and so the update, can flip between the two float
  orders; a flip moves a parameter by at most 2 lr per step;
- Adam moments: rtol 1e-3 plus 1e-3 of the tensor's largest entry (the
  moments are raw gradients; near-zero entries carry summation noise),
  with a floor of 1e-7 on mu and 1e-12 on nu: the attention key biases
  have an analytic gradient of 0 (a softmax does not see a shift), so
  both sides hold only float noise (~1e-8) there.
The targets sit near distinct predicted slots so that the matching has a
clear margin: a near-tie would let float noise swap two targets, which
keeps the loss and changes the gradient (grad_norm would show it).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.train.state import create_train_state as jax_create_state
from wireframe_tpu.train.step import make_train_step as jax_make_train_step
from wireframe_tpu.utils.synth import make_random_batch as jax_random_batch
from wireframe_tpu_torch.bridge import (
    flatten_params,
    params_from_flax,
    state_dict_to_flax,
)
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.train.state import create_train_state
from wireframe_tpu_torch.train.step import make_train_step
from wireframe_tpu_torch.utils.synth import make_random_batch

RECIPE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "recommended.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_chain_tile=32",
         "data.num_points=64", "train.batch_size=2",
         "model.compute_dtype=float32", "train.matcher=pallas",
         "model.attn_dropout=0", "model.edge_dropout=0",
         "train.device_augment=false", "train.num_epochs=3"]
STEPS = 3


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _np_tree(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("schedule", [
    ["train.lr_schedule=constant"],
    # warmup_cosine: lr(0) = 0, then 1.5e-4 and 3e-4.
    ["train.lr_schedule=warmup_cosine", "train.warmup_steps=2"],
])
def test_three_steps_match_make_train_step(schedule):
    overrides = SMALL + schedule
    jcfg = jax_load_config(RECIPE, overrides)
    cfg = load_config(RECIPE, overrides)
    b, n, d = 2, 64, jcfg.model.input_dim

    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0), (b, n, d))
    flat = _np_tree(jstate.params)
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    flat["vertex_decoder/slot_queries"] = rng.normal(
        size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)
    jstate = jstate.replace(params=_nested(flat), ema_params=_nested(flat))

    batch = make_random_batch(cfg, b, seed=3)
    jbatch = jax_random_batch(jcfg, b, seed=3)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])

    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    # Targets near distinct predicted slots (a random slot per target, plus
    # 0.05 noise): the matching then has a clear margin.  With targets far
    # from every slot, L1 costs tie or nearly tie, and float noise between
    # the two packages could swap two targets: an equal loss, another
    # gradient.
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["point_clouds"]),
                     torch.from_numpy(batch["vertex_counts"]),
                     train=True)["vertices"].numpy()
    for i, c in enumerate(batch["vertex_counts"]):
        slots = rng.permutation(pred.shape[1])[:c]
        batch["target_vertices"][i, :c] = (
            pred[i, slots] + rng.normal(size=(c, 3)) * 0.05)
    jbatch = {k: v.copy() for k, v in batch.items()}
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    jstep = jax.jit(jax_make_train_step(jcfg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    lr_sum = 0.0
    for i in range(STEPS):
        lr_sum += step.optimizer.lr(state.step)
        state, got = step(state, tbatch, torch.Generator().manual_seed(i))
        jstate, want = jstep(jstate, jb, jax.random.PRNGKey(i))
        rtol = 1e-5 if i == 0 else 1e-4
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(float(got[key]), float(w), rtol=rtol,
                                       atol=1e-6, err_msg=f"{key} step {i}")
    assert state.step == int(jstate.step) == STEPS
    assert lr_sum > 0

    tol = 2 * lr_sum + 1e-6
    got_p = state_dict_to_flax(state.params, cfg.model)
    want_p = _np_tree(jstate.params)
    got_e = state_dict_to_flax(state.ema_params, cfg.model)
    want_e = _np_tree(jstate.ema_params)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=tol,
                                   err_msg=k)
        np.testing.assert_allclose(got_e[k], want_e[k], rtol=0, atol=tol,
                                   err_msg=k)
    moved = max(np.abs(got_p[k] - flat[k]).max() for k in flat)
    assert moved > 0.5 * step.optimizer.lr(STEPS - 1)

    adam = jstate.opt_state[2]
    for name, mine, theirs, floor in (("mu", state.mu, adam.mu, 1e-7),
                                      ("nu", state.nu, adam.nu, 1e-12)):
        got_m = state_dict_to_flax(mine, cfg.model)
        want_m = _np_tree(theirs)
        for k in want_m:
            scale = np.abs(want_m[k]).max()
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-3,
                                       atol=1e-3 * scale + floor,
                                       err_msg=f"{name} {k}")


def test_dropout_only_in_train_mode_and_attention_mask_is_shared():
    """Dropout acts in train mode only; the attention-weight mask is one
    (Q, K) mask for every batch element and head (flax's
    broadcast_dropout), scaled by 1/keep in the module dtype."""
    from wireframe_tpu_torch.models.attention import (
        MultiHeadDotProductAttention,
    )
    from wireframe_tpu_torch.models.layers import dropout

    torch.manual_seed(0)
    att = MultiHeadDotProductAttention(16, 4, torch.float32, dropout_rate=0.5)
    x = torch.randn(3, 6, 16)
    with torch.no_grad():
        eval_out = att(x, x)
        assert torch.equal(att(x, x, train=False), eval_out)
        weights = {}
        # Capture the post-dropout weights: they feed the second einsum.
        orig = torch.einsum

        def spy(eq, *ops):
            if eq == "bhqk,bkhd->bqhd":
                weights["w"] = ops[0]
            return orig(eq, *ops)

        torch.einsum = spy
        try:
            att(x, x, train=True, generator=torch.Generator().manual_seed(1))
        finally:
            torch.einsum = orig
    w = weights["w"]                                   # (B, H, Q, K)
    dropped = w == 0
    assert dropped.any() and not dropped.all()
    assert torch.equal(dropped, dropped[:1, :1].expand_as(dropped))
    kept = w[~dropped]
    ref = torch.softmax(torch.einsum(
        "bqhd,bkhd->bhqk",
        att._heads(att.query(x)) / torch.tensor(2.0),
        att._heads(att.key(x))), dim=-1)[~dropped]
    np.testing.assert_allclose(kept.numpy(), (ref * 2.0).detach().numpy(),
                               rtol=1e-5)

    y = torch.ones(1000)
    assert torch.equal(dropout(y, 0.1, False, None), y)
    out = dropout(y, 0.1, True, torch.Generator().manual_seed(0))
    vals = np.unique(out.numpy())
    assert np.all(np.isclose(vals, 0.0) | np.isclose(vals, 1 / 0.9))
    assert 0.05 < float((out == 0).float().mean()) < 0.15


def test_model_train_mode_uses_gt_counts_and_dropout():
    """In prefix slot-mask mode, train=True lets the GT counts drive the
    edge head; with the recipe's edge dropout two generators give two
    outputs, and eval mode ignores the generator."""
    overrides = [o for o in SMALL if "dropout" not in o] + [
        "model.slot_mask_mode=prefix"]
    cfg = load_config(RECIPE, overrides)
    model = PointCloudToWireframe(cfg.model)
    x = torch.from_numpy(make_random_batch(cfg, 2, seed=1)["point_clouds"])
    counts = torch.tensor([3, 6], dtype=torch.int32)
    with torch.no_grad():
        a = model(x, counts, train=True,
                  generator=torch.Generator().manual_seed(0))
        b = model(x, counts, train=True,
                  generator=torch.Generator().manual_seed(1))
        e1 = model(x, counts, train=False)
        e2 = model(x, counts, train=False,
                   generator=torch.Generator().manual_seed(1))
    assert torch.equal(a["used_vertex_counts"], counts)
    assert not torch.equal(a["edge_logits"], b["edge_logits"])
    assert torch.equal(e1["edge_logits"], e2["edge_logits"])
    assert torch.equal(e1["used_vertex_counts"], e1["actual_vertex_counts"])


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, row):
        self.rows.append(row)


def test_train_model_cadence_best_checkpoint_and_serving(tmp_path):
    """The loop on the CPU over box-building batches: overfit mode logs at
    every `log_every` epoch and the last; `save_best` writes the PRE-update
    params of the best logged step (with one epoch: the initial params);
    the checkpoint serves; epoch mode takes one step per batch."""
    from wireframe_tpu_torch.bridge import load_port_checkpoint
    from wireframe_tpu_torch.serve import WireframePredictor
    from wireframe_tpu_torch.train.loop import init_model, train_model
    from wireframe_tpu_torch.utils.synth import (
        box_building_cloud,
        make_box_building_batch,
    )

    base = [o for o in SMALL if not o.startswith("train.num_epochs")] + [
        "train.lr_schedule=constant", "data.point_buckets=64,128",
        f"train.checkpoint_dir={tmp_path}"]
    cfg = load_config(RECIPE, base + ["train.num_epochs=4",
                                      "train.log_every=2"])
    batch = make_box_building_batch(cfg, 2, seed=0)
    assert batch["point_clouds"].shape == (2, 64, 8)
    np.testing.assert_array_equal(batch["vertex_counts"], [8, 8])
    np.testing.assert_array_equal(batch["edge_labels"].sum(-1), [12, 12])
    radius = np.linalg.norm(batch["point_clouds"][..., :3], axis=-1).max(-1)
    np.testing.assert_allclose(radius, 1.0, rtol=1e-6)
    assert np.all(np.diff(batch["point_clouds"][..., 2], axis=-1) >= 0)

    rows = _Rows()
    state = train_model(cfg, [batch], metric_writer=rows, device="cpu")
    assert state.step == 4
    assert [r["epoch"] for r in rows.rows] == [0, 2, 3]
    losses = [r["total_loss"] for r in rows.rows]
    assert np.all(np.isfinite(losses))
    assert rows.rows[-1]["best_loss"] == min(losses)
    assert all(r["learning_rate"] == cfg.train.learning_rate
               for r in rows.rows)

    one = load_config(RECIPE, base + ["train.num_epochs=1",
                                      "train.save_best=true"])
    train_model(one, [batch], device="cpu")
    saved, _ = load_port_checkpoint(str(tmp_path / "best"))
    init = state_dict_to_flax(init_model(one, "cpu").state_dict(), one.model)
    assert set(saved) == set(init)
    for k in init:
        np.testing.assert_array_equal(saved[k], init[k], err_msg=k)
    predictor = WireframePredictor(str(tmp_path / "best"), config=RECIPE,
                                   overrides=base, serve_batch_size=2,
                                   device="cpu")
    raw, _ = box_building_cloud(np.random.default_rng(1), 100)
    out = predictor.predict([raw])[0]
    assert np.isfinite(out["vertices"]).all()

    epochs = load_config(RECIPE, base + ["train.num_epochs=2",
                                         "train.overfit_one_batch=false"])
    loader = [batch, make_box_building_batch(cfg, 2, seed=1)]
    assert train_model(epochs, loader, device="cpu").step == 4


def test_pair_table_cached_in_inference_mode_serves_autograd():
    """Serving (inference mode) and then training in one process: the
    cached pair table must be a normal tensor that autograd can save."""
    from wireframe_tpu_torch.ops.pairs import triu_pairs_on

    triu_pairs_on.cache_clear()
    try:
        with torch.inference_mode():
            pairs = triu_pairs_on(5, torch.device("cpu"))
        assert not pairs.is_inference()
        x = torch.randn(2, 5, 3, requires_grad=True)
        x[:, pairs[:, 0], :].sum().backward()
        assert torch.equal(x.grad.sum(dim=(0, 2)),
                           torch.tensor([24.0, 18.0, 12.0, 6.0, 0.0]))
    finally:
        triu_pairs_on.cache_clear()
