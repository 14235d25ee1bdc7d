"""Three train steps of the port against the JAX package's make_train_step
(and, for ROADMAP C1, thirty: the `C1` tests state their own
tolerances).

The recipe at small width (`configs/recommended.yaml`: query decoder,
existence slot masks, slot features, kv_pool 4 through the stash chain,
or through the remat chain K5, matched edge and existence labels, EMA
0.999), and the reference-parity model (`configs/default.yaml` with
`model.use_pallas_encoder=true`: the MLP vertex head, the remat chain in
its features flavour with eager pools, positional edge and existence
labels, prefix slot masks, `matcher="device"`, constant LR), in f32,
from the same flax-initialized weights (carried over by the bridge, with
randomized biases and slot queries), on the same `make_random_batch`
arrays.  The JAX side runs its Pallas kernels in interpret mode; the
recipe uses `train.matcher=pallas`, so both sides use the lockstep tie
rule, and the parity model `matcher="device"`, whose XLA loop gives the
same assignments (tests/test_torch_lsa.py).  Dropout is 0 and the device
augmentation off: both draw from different random streams.

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

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
RECIPE = os.path.join(CONFIGS, "recommended.yaml")
PARITY = os.path.join(CONFIGS, "default.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_chain_tile=32",
         "data.num_points=64", "train.batch_size=2",
         "model.compute_dtype=float32", "train.matcher=pallas",
         "model.attn_dropout=0", "model.edge_dropout=0",
         "train.device_augment=false", "train.num_epochs=3"]
PARITY_SMALL = ["model.encoder_hidden_dims=32,64",
                "model.encoder_output_dim=32", "data.max_vertices=8",
                "model.edge_hidden_dim=32", "model.edge_num_heads=4",
                "model.pallas_chain_tile=32", "data.num_points=64",
                "train.batch_size=2", "model.use_pallas_encoder=true",
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
    ["train.lr_schedule=constant", "model.chain_backward=remat"],
])
def test_three_steps_match_make_train_step(schedule):
    _three_steps_match(RECIPE, SMALL + schedule)


def test_parity_three_steps_match_make_train_step():
    cfg = load_config(PARITY, PARITY_SMALL)
    assert (cfg.model.vertex_head, cfg.model.chain_backward,
            cfg.train.matcher, cfg.model.slot_mask_mode) == (
                "mlp", "remat", "device", "prefix")
    assert not (cfg.train.matched_edge_labels
                or cfg.train.matched_existence_labels)
    _three_steps_match(PARITY, PARITY_SMALL)


def _three_steps_match(config, overrides, steps=STEPS):
    """`steps` (three) steps of both packages: every step's metrics, then
    the params, EMA and Adam moments."""
    jcfg = jax_load_config(config, overrides)
    cfg = load_config(config, overrides)
    b, n, d = 2, 64, jcfg.model.input_dim

    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0), (b, n, d))
    flat = _np_tree(jstate.params)
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    if "vertex_decoder/slot_queries" in flat:
        flat["vertex_decoder/slot_queries"] = rng.normal(
            size=flat["vertex_decoder/slot_queries"].shape).astype(
                np.float32)
    jstate = jstate.replace(
        params=_nested(flat),
        ema_params=None if jstate.ema_params is None else _nested(flat))

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
    for i in range(steps):
        lr_sum += step.optimizer.lr(state.step)
        state, got = step(state, tbatch, torch.Generator().manual_seed(i))
        jstate, want = jstep(jstate, jb, jax.random.PRNGKey(i))
        rtol = 1e-5 if i == 0 else 1e-4
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(float(got[key]), float(w), rtol=rtol,
                                       atol=1e-6, err_msg=f"{key} step {i}")
    assert state.step == int(jstate.step) == steps
    assert lr_sum > 0

    tol = 2 * lr_sum + 1e-6
    got_p = state_dict_to_flax(state.params, cfg.model)
    want_p = _np_tree(jstate.params)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert (state.ema_params is None) == (jstate.ema_params is None)
    if state.ema_params is not None:
        got_e = state_dict_to_flax(state.ema_params, cfg.model)
        want_e = _np_tree(jstate.ema_params)
        for k in want_e:
            np.testing.assert_allclose(got_e[k], want_e[k], rtol=0,
                                       atol=tol, err_msg=k)
    moved = max(np.abs(got_p[k] - flat[k]).max() for k in flat)
    assert moved > 0.5 * step.optimizer.lr(steps - 1)

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


C1_STEPS = 30


def _c1_setup(near_slots: bool):
    """ROADMAP C1's regime at small width on both packages: the recipe at
    its constant peak LR (3e-4), a batch of two box buildings (8 corners
    in 16 slots, so that half the slots are supervised not to exist), the
    same bridged weights (randomized biases and slot queries) and draws.
    With near_slots the targets are moved next to distinct predicted
    slots, as in the 3-step comparison; else they are the box corners."""
    from wireframe_tpu_torch.utils.synth import make_box_building_batch

    overrides = [o for o in SMALL if not o.startswith(
        ("train.num_epochs", "data.max_vertices"))] + [
        "data.max_vertices=16", "train.lr_schedule=constant",
        f"train.num_epochs={C1_STEPS}"]
    jcfg = jax_load_config(RECIPE, overrides)
    cfg = load_config(RECIPE, overrides)
    assert cfg.train.learning_rate == 3e-4
    b, n = 2, 64
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0), (b, n, 8))
    flat = _np_tree(jstate.params)
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    flat["vertex_decoder/slot_queries"] = rng.normal(
        size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)
    jstate = jstate.replace(params=_nested(flat), ema_params=_nested(flat))

    batch = make_box_building_batch(cfg, b, seed=0)
    np.testing.assert_array_equal(batch["vertex_counts"], [8, 8])
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    if near_slots:
        with torch.no_grad():
            pred = model(torch.from_numpy(batch["point_clouds"]),
                         torch.from_numpy(batch["vertex_counts"]),
                         train=True)["vertices"].numpy()
        for i, c in enumerate(batch["vertex_counts"]):
            slots = rng.permutation(pred.shape[1])[:c]
            batch["target_vertices"][i, :c] = (
                pred[i, slots] + rng.normal(size=(c, 3)) * 0.05)
    return cfg, jcfg, create_train_state(cfg, model), jstate, batch


def _c1_train(cfg, jcfg, state, jstate, batch):
    """C1_STEPS steps on both packages; returns both states and both
    per-step losses."""
    step = make_train_step(cfg)
    jstep = jax.jit(jax_make_train_step(jcfg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for i in range(C1_STEPS):
        state, got = step(state, tbatch, torch.Generator().manual_seed(i))
        jstate, want = jstep(jstate, jb, jax.random.PRNGKey(i))
        losses.append((float(got["total_loss"]), float(want["total_loss"])))
    assert state.step == int(jstate.step) == C1_STEPS
    return state, jstate, np.array(losses)


def _c1_existence(cfg, jcfg, state, jstate, batch):
    """Both models' existence logits and probabilities on the batch,
    through each package's inference forward."""
    from wireframe_tpu.train.step import make_forward_fn as jax_forward
    from wireframe_tpu_torch.train.step import make_forward_fn

    x = batch["point_clouds"]
    mine = make_forward_fn(cfg)(state.model, torch.from_numpy(x))
    theirs = jax.jit(jax_forward(jcfg))(jstate.params, jnp.asarray(x), None)
    return ({k: mine[k].numpy() for k in ("existence_logits",
                                          "existence_probabilities")},
            {k: np.asarray(theirs[k]) for k in ("existence_logits",
                                                "existence_probabilities")})


def test_thirty_constant_lr_steps_give_the_jax_existence_logits():
    """ROADMAP C1's regime with the targets next to distinct predicted
    slots (a clear matching margin): 30 steps on both packages, then both
    models' existence logits.  Tolerance: losses rtol 1e-4 at every step,
    logits atol 1e-3 (same f32 arithmetic in other summation orders; Adam
    normalizes each update to about lr, so a near-zero gradient whose
    sign flips moves a parameter by 2 lr).  C1's own box-corner targets
    are the two tests below."""
    cfg, jcfg, state, jstate, batch = _c1_setup(near_slots=True)
    state, jstate, losses = _c1_train(cfg, jcfg, state, jstate, batch)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-4)
    mine, theirs = _c1_existence(cfg, jcfg, state, jstate, batch)
    np.testing.assert_allclose(mine["existence_logits"],
                               theirs["existence_logits"], rtol=0, atol=1e-3)
    p = theirs["existence_probabilities"]
    clear = np.abs(p - 0.5) > 1e-3
    np.testing.assert_array_equal(
        mine["existence_probabilities"][clear] > 0.5, p[clear] > 0.5)
    assert 0 < (p > 0.5).sum() < p.size        # the logits are not all alike


def test_c1_box_corner_targets_tie_the_first_assignment():
    """On C1's own targets (the box corners) the packages part at step 0,
    by a tie and not a fault.  From the same weights both forwards give
    cost matrices (the loss's transposed cost: targets x slots, L1 + 2 -
    2p) within 2e-6 of each other; on either matrix K4's plain version
    picks the assignment the JAX Pallas solver (interpret mode) picks, to
    the index; yet the two matrices lead to different assignments, and
    each of them is optimal on both matrices within 2e-5 (8 matched
    entries, each within the matrices' 2e-6 agreement).  The two
    packages' first losses then differ by more than 1e-3 (relative), as
    the same optimum through other slots gives another loss."""
    from scipy.optimize import linear_sum_assignment

    from wireframe_tpu.ops.pallas_lsa import solve_lsa_rows_pallas
    from wireframe_tpu.train.step import make_forward_fn as jax_forward
    from wireframe_tpu_torch.ops.lockstep_lsa import solve_lsa_rows
    from wireframe_tpu_torch.train.step import make_forward_fn

    cfg, jcfg, state, jstate, batch = _c1_setup(near_slots=False)
    x, counts = batch["point_clouds"], batch["vertex_counts"]
    tgt = batch["target_vertices"]
    mine = make_forward_fn(cfg)(state.model, torch.from_numpy(x),
                                torch.from_numpy(counts))
    theirs = jax.jit(jax_forward(jcfg))(jstate.params, jnp.asarray(x),
                                        jnp.asarray(counts))

    def cost(v, p):
        l1 = np.abs(v[:, :, None, :] - tgt[:, None, :, :]).sum(-1)
        return (l1.transpose(0, 2, 1) + (2.0 - 2.0 * p)[:, None, :]).astype(
            np.float32)

    cm = cost(mine["vertices"].numpy(),
              mine["existence_probabilities"].numpy())
    cj = cost(np.asarray(theirs["vertices"]),
              np.asarray(theirs["existence_probabilities"]))
    assert np.abs(cm - cj).max() <= 2e-6
    c32 = counts.astype(np.int32)
    slots = {}
    for name, c in (("port", cm), ("jax", cj)):
        plain = solve_lsa_rows(torch.from_numpy(c), torch.from_numpy(c32))
        pallas = solve_lsa_rows_pallas(jnp.asarray(c), jnp.asarray(c32),
                                       interpret=True)
        np.testing.assert_array_equal(plain.numpy(), np.asarray(pallas))
        slots[name] = plain.numpy()
    assert not np.array_equal(slots["port"], slots["jax"])
    for i, k in enumerate(counts):
        rows = np.arange(k)
        for c in (cm, cj):
            r, col = linear_sum_assignment(c[i, :k].astype(np.float64))
            best = c[i, :k][r, col].astype(np.float64).sum()
            for s in slots.values():
                got = c[i, rows, s[i, :k]].astype(np.float64).sum()
                assert abs(got - best) <= 2e-5

    step = make_train_step(cfg)
    jstep = jax.jit(jax_make_train_step(jcfg))
    _, got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  torch.Generator().manual_seed(0))
    _, want = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(0))
    a, b = float(got["total_loss"]), float(want["total_loss"])
    assert abs(a - b) > 1e-3 * abs(b)


def test_c1_box_corner_targets_keep_live_slots_on_both_packages():
    """C1's own regime at small width, 30 steps on each package from the
    tie above: the two runs follow other (equally optimal) assignments,
    so they are held as two trajectories, not as one float order.  Both
    losses fall, both models' existence probabilities end within 1e-2 of
    each other (4.2e-3 measured), and both keep live slots: the same
    slots above 0.5 wherever a probability is more than 1e-2 from 0.5,
    and at least one.  So at small width neither package serves C1's
    empty wireframe."""
    cfg, jcfg, state, jstate, batch = _c1_setup(near_slots=False)
    state, jstate, losses = _c1_train(cfg, jcfg, state, jstate, batch)
    assert np.isfinite(losses).all()
    assert (losses[-3:].mean(0) < losses[:3].mean(0)).all()
    mine, theirs = _c1_existence(cfg, jcfg, state, jstate, batch)
    pm = mine["existence_probabilities"]
    pj = theirs["existence_probabilities"]
    np.testing.assert_allclose(pm, pj, rtol=0, atol=1e-2)
    clear = np.abs(pj - 0.5) > 1e-2
    np.testing.assert_array_equal(pm[clear] > 0.5, pj[clear] > 0.5)
    assert 0 < (pm > 0.5).sum() < pm.size
    assert 0 < (pj > 0.5).sum() < pj.size


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
