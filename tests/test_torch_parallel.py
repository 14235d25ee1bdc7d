"""The port's multi-device path against the JAX package's.

- `resolve_layout` against `resolve_mesh` on 1, 2, 4 and 8 of the 8
  virtual devices (tests/conftest.py): the same (dp, mp) or the same
  error, except the one recorded divergence (dp=-1 with no width above 1
  dividing the batch: the JAX package warns and uses one device, the
  port raises), which has its own test.
- `host_shard_indices` / `host_batch_slice` equal to the JAX functions;
  `local_rows` equal to the `addressable_shards` of `shard_batch`.
- The loss: each rank's share, computed with the global batch's
  normalisers and no process group, sums to the JAX loss of the global
  batch (rtol 1e-6, f32), and the shares' gradients are the JAX
  gradients' rows (rtol 1e-4, atol 1e-6, as tests/test_torch_loss.py).
- The collective audit raises on an oversized all-gather and an
  oversized reduce-scatter, and leaves all-reduces out.
- `train_model` with `parallel.mp > 1` in one process raises, naming the
  ranks it needs (point-parallel training itself:
  tests/test_torch_point_parallel.py).
- Two gloo ranks on the CPU, in one start of two processes (each runs
  `_RANK`, which imports torch and the port only), checked here against
  references computed in this process:
  - one data-parallel train step of the recipe at small width in f32,
    device augmentation on (jitter and scale too), dropout off, each rank
    on 2 of the 4 rows (targets next to distinct predicted slots,
    `utils.synth.targets_near_slots`: from an untrained model the
    matching's costs tie, and the rows' float noise would pick another
    optimal assignment), under the collective audit: four all-reduces
    (the two normalisers, the flat gradient, the metric sums) and no
    data collective.  Against the port's one-process step on the 4 rows:
    losses and metrics rtol 1e-5, params atol 1e-5, Adam's first moment
    (0.1 x the gradient after one step) rtol 1e-3 plus 1e-3 of the
    tensor's largest entry with a floor of 1e-7 (as tests/
    test_torch_train.py).  Against the JAX one-device step on the same
    weights and the same augmented batch (the port's draws; the JAX step
    with its device augmentation off): the JAX test's tolerances
    (tests/test_sharding.py:228-284), existence and edge loss rtol 1e-5,
    vertex loss 1e-2, params atol 2.5e-3, and Adam's first moment at the
    tolerance above, so that a gradient that differs from the JAX step's
    fails even where Adam's sign-like first update hides it in the
    params.  The learning rate is 4e-6:
    Adam's first update moves every parameter by about lr with the sign
    of its gradient, and where a gradient is float noise (the attention
    key biases' analytic gradient is 0) the sign is a coin flip, which
    moves a parameter by 2 lr = 8e-6 < 1e-5; the gradients themselves
    are held through the first moment;
  - `gather_merge` of arange(9) * (rank + 1) is the exact sum on both
    ranks; `assemble_global_batch` of the local rows is the global
    batch; `replicate_across_hosts` raises on both ranks when rank 1
    holds other values;
  - `sharded_point_pools` at mp = 2 (K1's plain version per rank, f32,
    a cloud with padding in one rank's slice and a cloud whose second
    slice is all padding) against the unsharded K1 call and the JAX
    `sharded_point_pools` on a (1, 2) mesh: rtol 1e-5, atol 1e-6.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.config import Config as JaxConfig
from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.losses.wireframe_loss import (
    WireframeLossConfig as JaxLossConfig,
    wireframe_loss as jax_wireframe_loss,
)
from wireframe_tpu.parallel.mesh import make_mesh, resolve_mesh, shard_batch
from wireframe_tpu.parallel.multihost import (
    host_batch_slice as jax_host_batch_slice,
    host_shard_indices as jax_host_shard_indices,
)
from wireframe_tpu.parallel.sharded_pool import (
    sharded_point_pools as jax_sharded_point_pools,
)
from wireframe_tpu.train.state import create_train_state as jax_create_state
from wireframe_tpu.train.step import make_train_step as jax_make_train_step
from wireframe_tpu_torch.bridge import (
    flatten_params,
    params_from_flax,
    state_dict_to_flax,
)
from wireframe_tpu_torch.config import Config, load_config
from wireframe_tpu_torch.data.augment import augment_batch
from wireframe_tpu_torch.losses.wireframe_loss import (
    WireframeLossConfig,
    wireframe_loss,
)
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.ops.fused_encoder import fused_point_encoder
from wireframe_tpu_torch.ops.pairs import triu_pairs_np
from wireframe_tpu_torch.parallel import collective_audit
from wireframe_tpu_torch.parallel.mesh import local_rows, resolve_layout
from wireframe_tpu_torch.parallel.multihost import (
    host_batch_slice,
    host_shard_indices,
)
from wireframe_tpu_torch.train.loop import train_model
from wireframe_tpu_torch.train.state import create_train_state
from wireframe_tpu_torch.train.step import make_train_step
from wireframe_tpu_torch.utils.synth import (
    make_random_batch,
    targets_near_slots,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_chain_tile=32",
         "data.num_points=64", "train.batch_size=4",
         "model.compute_dtype=float32", "train.matcher=pallas",
         "model.attn_dropout=0", "model.edge_dropout=0",
         "train.lr_schedule=constant", "train.learning_rate=4e-6"]
AUG = ["train.device_augment=true", "train.aug_jitter_std=0.005",
       "train.aug_scale_range=0.1"]
BATCH = 4
SEED = 11

# (dp, mp, global batch, data.num_points)
LAYOUTS = [(1, 1, 8, 64), (-1, 1, 8, 64), (-1, 1, 6, 64), (-1, 1, 7, 64),
           (-1, 2, 8, 64), (-1, 3, 8, 63), (2, 1, 8, 64), (4, 2, 8, 64),
           (2, 2, 6, 64), (8, 1, 3, 64), (3, 1, 8, 64), (2, 3, 8, 64),
           (16, 1, 16, 64), (0, 1, 8, 64), (-2, 1, 8, 64), (1, 0, 8, 64),
           (-1, 16, 8, 64)]


def _divergent(n, dp, mp, bs, npts):
    """The recorded divergence: dp=-1 resolving to one device of many."""
    if dp != -1 or mp != 1 or n == 1:
        return False
    return max(d for d in range(1, n + 1) if bs % d == 0) == 1


def _configs(dp, mp, bs, npts):
    out = []
    for c in (JaxConfig(), Config()):
        c.parallel.dp, c.parallel.mp = dp, mp
        c.train.batch_size = bs
        c.data.num_points = npts
        out.append(c)
    return out


def _outcome(fn):
    try:
        return fn()
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("n,case", [
    (n, case) for n in (1, 2, 4, 8) for case in LAYOUTS
    if not _divergent(n, *case)])
def test_resolve_layout_is_resolve_mesh(n, case):
    jcfg, cfg = _configs(*case)

    def jax_layout():
        mesh = resolve_mesh(jcfg, devices=jax.devices()[:n])
        return None if mesh is None else (mesh.shape["dp"], mesh.shape["mp"])

    assert _outcome(lambda: resolve_layout(cfg, n)) == _outcome(jax_layout)


@pytest.mark.parametrize("n,bs", [(2, 3), (8, 11)])
def test_resolve_layout_raises_where_the_jax_package_idles_devices(n, bs):
    jcfg, cfg = _configs(-1, 1, bs, 64)
    assert resolve_mesh(jcfg, devices=jax.devices()[:n]) is None
    with pytest.raises(ValueError, match=f"train.batch_size={bs} on {n}"):
        resolve_layout(cfg, n)


def test_host_shard_math_is_the_jax_package_s():
    for num, count in ((43, 4), (10, 3), (8, 8), (5, 8)):
        for pi in range(count):
            assert host_shard_indices(num, pi, count) == \
                jax_host_shard_indices(num, pi, count)
    for gb, count in ((64, 8), (8, 2), (6, 3)):
        assert host_batch_slice(gb, 0, count) == \
            jax_host_batch_slice(gb, 0, count)
    with pytest.raises(ValueError, match="not divisible"):
        host_batch_slice(10, 0, 4)
    assert host_shard_indices(5) == list(range(5))   # no process group


@pytest.mark.parametrize("dp", [8, 4, 2])
def test_local_rows_are_shard_batch_s_shards(dp):
    cfg = Config()
    cfg.data.num_points, cfg.data.max_vertices = 16, 8
    cfg.__post_init__()
    batch = make_random_batch(cfg, 8, seed=5)
    sharded = shard_batch(make_mesh(dp=dp, mp=1), batch)
    m = 8 // dp
    for k, arr in sharded.items():
        seen = set()
        for shard in arr.addressable_shards:
            rank = (shard.index[0].start or 0) // m
            seen.add(rank)
            np.testing.assert_array_equal(np.asarray(shard.data),
                                          local_rows(batch, rank, dp)[k])
        assert seen == set(range(dp)), k


V = 8
E = V * (V - 1) // 2


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    counts = np.array([3, 8, 0, 5], np.int32)
    live = np.arange(V)[None, :] < counts[:, None]
    pairs = triu_pairs_np(V)
    slot_live = rng.random((4, V)) > 0.3
    pred = {
        "vertices": rng.normal(size=(4, V, 3)).astype(np.float32),
        "existence_logits": rng.normal(size=(4, V)).astype(np.float32) * 2,
        "edge_logits": rng.normal(size=(4, E)).astype(np.float32),
        "pair_mask": slot_live[:, pairs[:, 0]] & slot_live[:, pairs[:, 1]],
    }
    tgt = {
        "vertices": (rng.normal(size=(4, V, 3)) * live[..., None]).astype(
            np.float32),
        "vertex_existence": live.astype(np.float32),
        "edge_labels": (rng.random((4, E)) < 0.3).astype(np.float32),
        "vertex_counts": counts,
    }
    return pred, tgt


def _port_loss(pred, tgt, cfg, norms=None):
    leaves = {k: torch.tensor(pred[k], requires_grad=True)
              for k in ("vertices", "existence_logits", "edge_logits")}
    p = dict(leaves, existence_probabilities=torch.sigmoid(
        leaves["existence_logits"]),
        pair_mask=torch.from_numpy(pred["pair_mask"]))
    out = wireframe_loss(p, {k: torch.from_numpy(v) for k, v in tgt.items()},
                         cfg, norms=norms)
    out["total_loss"].backward()
    return out, {k: t.grad.numpy() for k, t in leaves.items()}


@pytest.mark.parametrize("matched", [False, True])
def test_rank_loss_shares_sum_to_the_jax_global_loss(matched):
    pred, tgt = _loss_inputs(3)
    flags = dict(matched_edge_labels=matched,
                 matched_existence_labels=matched)
    jcfg = JaxLossConfig(matcher="pallas", **flags)
    cfg = WireframeLossConfig(matcher="pallas", **flags)

    def f(v, logits, edge_logits):
        p = {"vertices": v, "existence_logits": logits,
             "existence_probabilities": jax.nn.sigmoid(logits),
             "edge_logits": edge_logits,
             "pair_mask": jnp.asarray(pred["pair_mask"])}
        out = jax_wireframe_loss(p, {k: jnp.asarray(x)
                                     for k, x in tgt.items()}, jcfg)
        return out["total_loss"], out

    (_, want), jgrads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(pred[k]) for k in ("vertices", "existence_logits",
                                             "edge_logits")))

    ranks = [local_rows(pred, r, 2) for r in range(2)]
    rank_tgts = [local_rows(tgt, r, 2) for r in range(2)]
    # The global normalisers: the SUM of the ranks' matched-slot counts
    # and the MAX of their pair counts (what the train step all-reduces).
    total = 0.0
    max_pairs = 0.0
    for p, t in zip(ranks, rank_tgts):
        out, _ = _port_loss(p, t, cfg)
        c = torch.from_numpy(t["vertex_counts"])
        total += float(torch.sum(out["matched_cols"] < c[:, None]))
        max_pairs = max(max_pairs, float(torch.amax(c * (c - 1) // 2)))

    def norms(t, m):
        return torch.tensor(total), torch.tensor(max_pairs), BATCH

    shares = [_port_loss(p, t, cfg, norms) for p, t in zip(ranks,
                                                           rank_tgts)]
    for key in ("total_loss", "vertex_loss", "existence_loss", "edge_loss"):
        got = sum(float(out[key].detach()) for out, _ in shares)
        np.testing.assert_allclose(got, float(want[key]), rtol=1e-6,
                                   err_msg=key)
    for i, k in enumerate(("vertices", "existence_logits", "edge_logits")):
        got = np.concatenate([g[k] for _, g in shares])
        np.testing.assert_allclose(got, np.asarray(jgrads[i]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("op,raises", [
    ("all_gather", True), ("reduce_scatter", True), ("broadcast", True),
    ("all_reduce", False)])
def test_collective_audit_budget(op, raises):
    big = torch.zeros(300, 256)                        # 300 KiB of f32
    fn = getattr(collective_audit, op)

    def run():
        return collective_audit.audit_collectives(lambda: fn(big),
                                                  max_bytes=256 * 1024)

    if raises:
        with pytest.raises(AssertionError, match="oversized"):
            run()
    else:
        log = run()
        assert [(c.op, c.shape, c.bytes) for c in log] == [
            ("all_reduce", (300, 256), 300 * 256 * 4)]


def test_train_model_refuses_point_parallel_training():
    # One process holds no second point slice.
    cfg = load_config(RECIPE, SMALL + ["parallel.mp=2"])
    batch = make_random_batch(cfg, BATCH, seed=3)
    with pytest.raises(ValueError, match="parallel.mp=2 exceeds 1 devices"):
        train_model(cfg, [batch], device="cpu")


# One rank of the two-rank run: imports torch and the port only.
_RANK = r"""
import json, os, sys
sys.path.insert(0, os.environ["_REPO"])
import numpy as np
import torch

from wireframe_tpu_torch.bridge import params_from_flax, state_dict_to_flax
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.eval.distributed import (
    calculator_from_vector, counters_vector, gather_merge)
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.parallel.collective_audit import (
    audit_train_step_collectives)
from wireframe_tpu_torch.parallel.mesh import (
    init_distributed, local_rows, world)
from wireframe_tpu_torch.parallel.multihost import (
    assemble_global_batch, replicate_across_hosts)
from wireframe_tpu_torch.parallel.sharded_pool import sharded_point_pools
from wireframe_tpu_torch.train.state import create_train_state

init_distributed(backend="gloo", device="cpu")
rank, size = world()
inp = dict(np.load(os.environ["_IN"]))
cfg = load_config(os.environ["_CONFIG"], json.loads(os.environ["_SETS"]))
flat = {k[2:]: v for k, v in inp.items() if k.startswith("p/")}
batch = {k[2:]: v for k, v in inp.items() if k.startswith("b/")}
model = PointCloudToWireframe(cfg.model)
model.load_state_dict(params_from_flax(flat), strict=True)
state = create_train_state(cfg, model)
for tree in (state.model, state.mu, state.nu, state.ema_params):
    replicate_across_hosts(tree)
mine = {k: torch.from_numpy(v) for k, v in
        local_rows(batch, rank, size).items()}
log, metrics = audit_train_step_collectives(
    cfg, state, mine, torch.Generator().manual_seed(int(inp["seed"])))
out = {"m/" + k: float(v) for k, v in metrics.items()}
out.update({"p/" + k: v for k, v in
            state_dict_to_flax(state.params, cfg.model).items()})
out.update({"mu/" + k: v for k, v in
            state_dict_to_flax(state.mu, cfg.model).items()})
out["ops"] = np.array([c.op for c in log])
out["op_bytes"] = np.array([c.bytes for c in log])

ap = calculator_from_vector(np.arange(9.0) * (rank + 1), 1.0)
out["merged"] = counters_vector(gather_merge(ap))
glob = assemble_global_batch(mine)
out["assembled"] = all(np.array_equal(glob[k].numpy(), batch[k])
                       for k in batch)
try:
    replicate_across_hosts({"w": torch.full((3,), float(rank))})
    out["caught"] = False
except ValueError:
    out["caught"] = True

stages = [tuple(torch.from_numpy(inp[f"s{i}/{j}"]) for j in range(4))
          for i in range(int(inp["n_stages"]))]
pools = sharded_point_pools(torch.from_numpy(inp["x"]), stages,
                            torch.from_numpy(inp["fw"]),
                            torch.from_numpy(inp["fb"]),
                            compute_dtype=torch.float32, tile=32)
out.update({"pool/" + k: v.numpy() for k, v in pools.items()})
np.savez(os.environ["_OUT"], **out)
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script, env_extra, n=2, timeout=240):
    """Start `script` as n gloo ranks (torchrun's environment variables,
    a free localhost port); return their outputs, failing on a rank's
    non-zero exit."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), _REPO=ROOT, OMP_NUM_THREADS="1",
                   **{k: v.format(rank=rank) for k, v in env_extra.items()})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _pool_inputs(rng):
    n, d, widths, c = 64, 8, (32, 32), 32
    x = rng.normal(size=(2, n, d)).astype(np.float32)
    x[0, 40:] = 0.0              # padding inside rank 1's slice
    x[1, 32:] = 0.0              # rank 1's slice all padding
    stages, prev = [], d
    for h in widths:
        stages.append(((rng.normal(size=(prev, h)) * 0.3).astype(np.float32),
                       (rng.normal(size=h) * 0.1).astype(np.float32),
                       (1 + rng.normal(size=h) * 0.1).astype(np.float32),
                       (rng.normal(size=h) * 0.1).astype(np.float32)))
        prev = h
    fw = (rng.normal(size=(prev, c)) * 0.3).astype(np.float32)
    fb = (rng.normal(size=c) * 0.1).astype(np.float32)
    return x, stages, fw, fb


def test_two_gloo_ranks(tmp_path):
    sets = SMALL + AUG
    cfg = load_config(RECIPE, sets)
    assert cfg.train.device_augment and cfg.data.augment
    jcfg = jax_load_config(RECIPE, sets + ["train.device_augment=false"])
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0),
                              (BATCH, 64, jcfg.model.input_dim))
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    flat["vertex_decoder/slot_queries"] = rng.normal(
        size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    # Targets near distinct predicted slots: a clear matching margin.
    batch = targets_near_slots(cfg, model, make_random_batch(
        cfg, BATCH, seed=3), SEED)
    x, stages, fw, fb = _pool_inputs(rng)

    inputs = {"seed": SEED, "x": x, "fw": fw, "fb": fb,
              "n_stages": len(stages)}
    inputs.update({"p/" + k: v for k, v in flat.items()})
    inputs.update({"b/" + k: v for k, v in batch.items()})
    for i, st in enumerate(stages):
        inputs.update({f"s{i}/{j}": a for j, a in enumerate(st)})
    np.savez(tmp_path / "in.npz", **inputs)
    run_ranks(_RANK, {"_IN": str(tmp_path / "in.npz"),
                      "_OUT": str(tmp_path / "out{rank}.npz"),
                      "_CONFIG": RECIPE, "_SETS": json.dumps(sets)})
    ranks = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]

    # The port's one-process step on the global batch.
    state = create_train_state(cfg, model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, single = make_train_step(cfg)(
        state, tbatch, torch.Generator().manual_seed(SEED))
    single_p = state_dict_to_flax(state.params, cfg.model)
    single_mu = state_dict_to_flax(state.mu, cfg.model)

    # The JAX one-device step on the batch the port's draws augment.
    pc, tv = augment_batch(
        torch.Generator().manual_seed(SEED), tbatch["point_clouds"],
        tbatch["target_vertices"], rot_degrees=cfg.train.aug_rot_degrees,
        jitter_std=cfg.train.aug_jitter_std,
        scale_range=cfg.train.aug_scale_range)
    jbatch = dict(batch, point_clouds=pc.numpy(), target_vertices=tv.numpy())
    jstate = jstate.replace(params=_nested(flat),
                            ema_params=_nested(flat))
    jstate, want = jax.jit(jax_make_train_step(jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in jbatch.items()},
        jax.random.PRNGKey(0))
    jax_p = flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    jax_mu = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                   jstate.opt_state[2].mu))

    for r, got in enumerate(ranks):
        assert list(got["ops"]) == ["all_reduce"] * 4, got["ops"]
        # The flat gradient: every parameter in one f32 buffer.
        assert got["op_bytes"][2] == 4 * sum(v.size for v in flat.values())
        for key, val in single.items():
            np.testing.assert_allclose(got["m/" + key], float(val),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} {key}")
        for key, rtol in (("existence_loss", 1e-5), ("edge_loss", 1e-5),
                          ("vertex_loss", 1e-2)):
            np.testing.assert_allclose(got["m/" + key], float(want[key]),
                                       rtol=rtol, err_msg=f"rank {r} {key}")
        for k in flat:
            np.testing.assert_allclose(got["p/" + k], single_p[k], rtol=0,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got["p/" + k], jax_p[k], rtol=0,
                                       atol=2.5e-3, err_msg=k)
            for want_mu, who in ((single_mu, "one process"),
                                 (jax_mu, "JAX")):
                scale = np.abs(want_mu[k]).max()
                np.testing.assert_allclose(got["mu/" + k], want_mu[k],
                                           rtol=1e-3,
                                           atol=max(1e-3 * scale, 1e-7),
                                           err_msg=f"{who} mu {k}")
        np.testing.assert_array_equal(got["merged"], np.arange(9.0) * 3)
        assert got["assembled"] and got["caught"]

    # Point-sharded pools against the unsharded K1 call and JAX.
    t = [tuple(torch.from_numpy(a) for a in st) for st in stages]
    whole = fused_point_encoder(torch.from_numpy(x), t, torch.from_numpy(fw),
                                torch.from_numpy(fb), tile=32,
                                compute_dtype=torch.float32)
    jpools = jax_sharded_point_pools(
        make_mesh(dp=1, mp=2), jnp.asarray(x),
        [tuple(jnp.asarray(a) for a in st) for st in stages],
        jnp.asarray(fw), jnp.asarray(fb), compute_dtype=jnp.float32)
    assert np.all(ranks[0]["pool/masked_max"][1] != 0)
    for key in ("masked_mean", "masked_max", "mean", "max"):
        for r in range(2):
            got = ranks[r]["pool/" + key]
            np.testing.assert_allclose(got, whole[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_allclose(got, np.asarray(jpools[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
