"""Point-parallel training (`parallel.mp > 1`) against one process and
against the JAX package's one-device step.

The JAX package trains on a (dp, mp) mesh, where GSPMD splits the batch
over dp and each cloud's points over mp and computes exactly the
one-device step (tests/test_sharding.py:228-284).  The port runs one
process per rank (`parallel.mesh.Layout`: world rank r at dp index
r // mp, mp index r % mp).  Here gloo ranks on the CPU, started as
`tests/test_torch_parallel.py` starts them, at dp=1 x mp=2 and dp=2 x
mp=2 (4 processes), each for:

- the recipe (`configs/recommended.yaml`: query decoder, kv_pool 4, the
  stash chain K2 + K3, K4, matched labels) and
- the parity model (`configs/default.yaml` with the chain: MLP head, the
  remat chain K5, the four pools from `parallel.sharded_pool.
  point_pools_train`),

at a small width in f32, chain tile 32, N = 64 (32 points a rank), a
global batch of 4, device augmentation on without jitter, dropout off,
learning rate 4e-6 (as tests/test_torch_parallel.py: Adam's first update
moves a parameter by about lr with its gradient's sign, so a sign that
float noise flips moves it by 2 lr = 8e-6 < 1e-5).  Cloud 1's second
slice is all padding; cloud 0 holds a duplicated point, one copy in each
slice, that is the whole cloud's maximum in one feature channel (a
masked-max tie across the slice boundary); the targets sit next to
distinct predicted slots (`utils.synth.targets_near_slots`), so that no
matcher near-tie flips.  One step on every rank, held against:

(a) the port's one-process step on the global batch: losses and metrics
    rtol 1e-5, params atol 1e-5, Adam's first moment (0.1 x the clipped
    gradient) rtol 1e-3 plus 1e-3 of the tensor's largest entry with a
    floor of 1e-7 (tests/test_torch_parallel.py:520-524).  A gradient
    counted mp times (the decoder, edge head or fusion MLP summed over
    the world), a normaliser or metric sum reduced over the world, or a
    maximum's gradient handed to both holders of the tie fails it;
(b) the JAX one-device step (jitted, its device augmentation off, fed the
    port's augmented batch) on the same weights: existence and edge loss
    rtol 1e-5, vertex loss 1e-2 (tests/test_sharding.py:271-276), params
    atol 1e-5 and the first moment at (a)'s tolerance.

Also: the collective log of a recipe step at dp=2 x mp=2 (the KV
all-gather over mp, the masked-mean SUM over mp, the normalisers over
dp, the point MLP's gradients over the world and the rest over dp, the
metric sums over dp; no data collective over the 48 MB budget); the
backward of each differentiable collective on the ranks; the training
layout's refusals; and `torchrun --nproc_per_node 2 -m
wireframe_tpu_torch.main --set parallel.mp=2 --device cpu` against one
process (the metrics of `train_metrics.jsonl` rtol 1e-5).
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

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.train.state import create_train_state as jax_create_state
from wireframe_tpu.train.step import make_train_step as jax_make_train_step
from wireframe_tpu_torch.bridge import (
    flatten_params,
    init_flax_params,
    params_from_flax,
    state_dict_to_flax,
)
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.data.augment import augment_batch
from wireframe_tpu_torch.data.building3d import Building3DDataset
from wireframe_tpu_torch.data.loader import BatchLoader
from wireframe_tpu_torch.io.obj import save_wireframe
from wireframe_tpu_torch.main import main as main_cli
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.ops.fused_encoder import point_encoder_reference
from wireframe_tpu_torch.parallel.collective_audit import DEFAULT_MAX_BYTES
from wireframe_tpu_torch.parallel.mesh import resolve_layout
from wireframe_tpu_torch.tools.gen_demo_data import main as gen_main
from wireframe_tpu_torch.train.checkpoint import write_flax_checkpoint
from wireframe_tpu_torch.train.state import create_train_state
from wireframe_tpu_torch.train.step import make_train_step
from wireframe_tpu_torch.utils.synth import (
    make_random_batch,
    targets_near_slots,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
PARITY = os.path.join(ROOT, "configs", "default.yaml")
N, BATCH, SEED = 64, 4, 11
COMMON = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
          "data.max_vertices=8", "model.edge_hidden_dim=32",
          "model.edge_num_heads=4", "model.pallas_chain_tile=32",
          f"data.num_points={N}", f"train.batch_size={BATCH}",
          "model.compute_dtype=float32", "model.attn_dropout=0",
          "model.edge_dropout=0", "train.lr_schedule=constant",
          "train.learning_rate=4e-6", "train.device_augment=true",
          "train.aug_jitter_std=0", "train.aug_scale_range=0.1"]
MODELS = {
    "recipe": (RECIPE, COMMON + [
        "model.decoder_dim=32", "model.decoder_layers=2",
        "model.decoder_heads=4", "model.decoder_ffn_dim=64",
        "train.matcher=pallas"]),
    "parity": (PARITY, COMMON + ["model.use_pallas_encoder=true"]),
}
LAYOUTS = [(1, 2), (2, 2)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script, env_extra, n, timeout=240):
    """Start `script` as n gloo ranks (torchrun's environment variables,
    a free localhost port), failing on a rank's non-zero exit."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), _REPO=ROOT, OMP_NUM_THREADS="1",
                   **{k: v.replace("{rank}", str(rank))
                      for k, v in env_extra.items()})
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


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _augmented(cfg, batch):
    """The global batch as the step augments it (its generator's draws)."""
    return augment_batch(
        torch.Generator().manual_seed(SEED),
        torch.from_numpy(batch["point_clouds"]),
        torch.from_numpy(batch["target_vertices"]),
        rot_degrees=cfg.train.aug_rot_degrees,
        jitter_std=cfg.train.aug_jitter_std,
        scale_range=cfg.train.aug_scale_range)


def _features(model, clouds):
    enc = model.encoder
    with torch.no_grad():
        return point_encoder_reference(clouds, enc.stage_params(), enc.proj_w,
                                       enc.proj_b,
                                       compute_dtype=torch.float32).numpy()


def _spread(flat):
    """Random biases and slot queries: slots that sit apart, so that the
    targets placed next to them have a clear matching margin."""
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("_b"):
            flat[k] = (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    if "vertex_decoder/slot_queries" in flat:
        flat["vertex_decoder/slot_queries"] = rng.normal(
            size=flat["vertex_decoder/slot_queries"].shape).astype(np.float32)
    return flat


def _setup(name):
    """(cfg, flat params, batch, jax cfg, jax state) of one model."""
    config, sets = MODELS[name]
    cfg = load_config(config, sets)
    jcfg = jax_load_config(config, sets + ["train.device_augment=false"])
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0),
                              (BATCH, N, jcfg.model.input_dim))
    flat = _spread(flatten_params(jax.tree_util.tree_map(np.asarray,
                                                         jstate.params)))
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)

    batch = make_random_batch(cfg, BATCH, seed=3)
    pc = batch["point_clouds"]
    half = N // 2
    pc[1, half:] = 0.0                  # cloud 1: rank 1's slice all padding
    # Cloud 0: copy the point that holds the largest lead of slice 0 over
    # slice 1 in some channel into slice 1: a tie of the whole cloud's
    # maximum across the boundary (augmentation maps both copies alike).
    f = _features(model, _augmented(cfg, batch)[0][:1])[0]
    c = int(np.argmax(f[:half].max(0) - f[half:].max(0)))
    i0, j = int(np.argmax(f[:half, c])), half + 5
    pc[0, j] = pc[0, i0]
    f = _features(model, _augmented(cfg, batch)[0][:1])[0]
    assert f[j, c] == f[i0, c] == f[:, c].max(), "no tie across the slices"
    batch = targets_near_slots(cfg, model, batch, SEED)
    jstate = jstate.replace(params=_nested(flat), ema_params=_nested(flat))
    return cfg, flat, batch, jcfg, jstate


def _references(name, cfg, flat, batch, jcfg, jstate):
    """The port's one-process step and the JAX one-device step on the
    global batch: {"m", "p", "mu"} of each."""
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    state = create_train_state(cfg, model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, m = make_train_step(cfg)(state, tbatch,
                                    torch.Generator().manual_seed(SEED))
    one = {"m": {k: float(v) for k, v in m.items()},
           "p": state_dict_to_flax(state.params, cfg.model),
           "mu": state_dict_to_flax(state.mu, cfg.model)}

    pc, tv = _augmented(cfg, batch)
    jbatch = dict(batch, point_clouds=pc.numpy(), target_vertices=tv.numpy())
    jstate, jm = jax.jit(jax_make_train_step(jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in jbatch.items()},
        jax.random.PRNGKey(0))
    np_tree = lambda t: flatten_params(jax.tree_util.tree_map(np.asarray, t))
    ref_jax = {"m": {k: float(v) for k, v in jm.items()},
               "p": np_tree(jstate.params),
               "mu": np_tree(jstate.opt_state[2].mu)}
    return one, ref_jax


# One rank: imports torch and the port only.  Runs one step of each
# model under the collective audit, then checks the backward of each
# differentiable collective over its mp group.
_RANK = r"""
import json, os, sys
sys.path.insert(0, os.environ["_REPO"])
import numpy as np
import torch

from wireframe_tpu_torch.bridge import params_from_flax, state_dict_to_flax
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe
from wireframe_tpu_torch.parallel.collective_audit import (
    audit_train_step_collectives, gather_over_ranks, max_over_ranks,
    sum_over_ranks)
from wireframe_tpu_torch.parallel.mesh import (
    Layout, init_distributed, local_rows, resolve_layout, world)
from wireframe_tpu_torch.parallel.multihost import replicate_across_hosts
from wireframe_tpu_torch.train.state import create_train_state

init_distributed(backend="gloo", device="cpu")
rank, size = world()
models = json.loads(os.environ["_MODELS"])
out = {}
layout = None
for name, (config, sets) in models.items():
    inp = dict(np.load(os.environ["_IN"].format(name=name)))
    cfg = load_config(config, sets + [f"parallel.mp={os.environ['_MP']}"])
    dp, mp = resolve_layout(cfg, size, train=True)
    layout = layout or Layout.of_group(mp=mp)
    assert (layout.dp, layout.mp) == (dp, mp)
    assert (layout.dp_rank, layout.mp_rank) == (rank // mp, rank % mp)
    flat = {k[2:]: v for k, v in inp.items() if k.startswith("p/")}
    batch = {k[2:]: v for k, v in inp.items() if k.startswith("b/")}
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    state = create_train_state(cfg, model)
    for tree in (state.model, state.mu, state.nu, state.ema_params):
        if tree is not None:
            replicate_across_hosts(tree)
    mine = {k: torch.from_numpy(v) for k, v in
            local_rows(batch, layout.dp_rank, layout.dp).items()}
    log, metrics = audit_train_step_collectives(
        cfg, state, mine, torch.Generator().manual_seed(int(inp["seed"])),
        layout=layout)
    out.update({f"{name}/m/{k}": float(v) for k, v in metrics.items()})
    for part, tree in (("p", state.params), ("mu", state.mu)):
        out.update({f"{name}/{part}/{k}": v for k, v in
                    state_dict_to_flax(tree, cfg.model).items()})
    out[f"{name}/log"] = json.dumps(
        [[c.op, list(c.shape), c.bytes, c.ranks] for c in log])

# The collectives' backward over the mp group: 2 ranks, (1, 3) each.
g = layout.mp_group
r = layout.mp_rank
x = torch.tensor([[5.0, 1.0 + 3.0 * r, 2.0]], requires_grad=True)
w = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]])
(max_over_ranks(x, g).sum() * 7.0
 + (gather_over_ranks(x, g, dim=1) * w).sum()
 + sum_over_ranks(x * 11.0, g).sum()).backward()
out["grad"] = x.grad.numpy()
np.savez(os.environ["_OUT"], **out)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's rank outputs, and each model's references."""
    tmp = tmp_path_factory.mktemp("point_parallel")
    refs = {}
    for name in MODELS:
        cfg, flat, batch, jcfg, jstate = _setup(name)
        inputs = {"seed": SEED}
        inputs.update({"p/" + k: v for k, v in flat.items()})
        inputs.update({"b/" + k: v for k, v in batch.items()})
        np.savez(tmp / f"in_{name}.npz", **inputs)
        refs[name] = _references(name, cfg, flat, batch, jcfg, jstate)
    out = {}
    for dp, mp in LAYOUTS:
        n = dp * mp
        run_ranks(_RANK, {"_IN": str(tmp / "in_{name}.npz"),
                          "_OUT": str(tmp / f"out{n}_{{rank}}.npz"),
                          "_MP": str(mp), "_MODELS": json.dumps(MODELS)}, n)
        out[dp, mp] = [_unpack(np.load(tmp / f"out{n}_{r}.npz"))
                       for r in range(n)]
    return out, refs


def _unpack(npz):
    """{model: {"m", "p", "mu": {key: value}, "log": [...]}, "grad": ...}
    of one rank's output."""
    out = {"grad": npz["grad"]}
    for key in npz.files:
        name, _, rest = key.partition("/")
        if name not in MODELS:
            continue
        part, _, k = rest.partition("/")
        node = out.setdefault(name, {"m": {}, "p": {}, "mu": {}})
        if part == "log":
            node["log"] = json.loads(str(npz[key]))
        else:
            node[part][k] = npz[key]
    return out


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("dp,mp", LAYOUTS)
def test_point_parallel_step_is_the_one_process_step(runs, dp, mp, name):
    out, refs = runs
    one, ref_jax = refs[name]
    for r, rank_out in enumerate(out[dp, mp]):
        got = rank_out[name]
        for key, val in one["m"].items():
            np.testing.assert_allclose(got["m"][key], val, rtol=1e-5,
                                       atol=1e-7, err_msg=f"rank {r} {key}")
        for key, rtol in (("existence_loss", 1e-5), ("edge_loss", 1e-5),
                          ("vertex_loss", 1e-2)):
            np.testing.assert_allclose(got["m"][key], ref_jax["m"][key],
                                       rtol=rtol, err_msg=f"rank {r} {key}")
        for k in one["p"]:
            p, mu = got["p"][k], got["mu"][k]
            for ref, who in ((one, "one process"), (ref_jax, "JAX")):
                np.testing.assert_allclose(p, ref["p"][k], rtol=0, atol=1e-5,
                                           err_msg=f"{who} params {k}")
                scale = np.abs(ref["mu"][k]).max()
                np.testing.assert_allclose(
                    mu, ref["mu"][k], rtol=1e-3,
                    atol=max(1e-3 * scale, 1e-7), err_msg=f"{who} mu {k}")


def test_collective_log_of_a_recipe_step(runs):
    out, _ = runs
    kv = BATCH // 2 * (N // 4 // 2) * 32 * 4      # (2, 8, 32) f32 a rank
    for rank_out in out[2, 2]:
        log = rank_out["recipe"]["log"]
        assert [(op, ranks) for op, _, _, ranks in log] == [
            ("all_gather", 2),        # pooled KV over mp
            ("all_reduce", 2),        # window sums over mp
            ("all_reduce", 2),        # matched-slot count over dp
            ("all_reduce", 2),        # max pair count over dp
            ("all_reduce", 4),        # point MLP gradients over the world
            ("all_reduce", 2),        # every other gradient over dp
            ("all_reduce", 2)], log   # metric sums over dp
        assert log[0][2] == kv
        assert all(b <= DEFAULT_MAX_BYTES for _, _, b, _ in log)
        pools = [op for op, _, _, _ in rank_out["parity"]["log"][:3]]
        assert pools == ["all_reduce"] * 3      # 1 SUM, 2 MAX over mp


@pytest.mark.parametrize("dp,mp", LAYOUTS)
def test_differentiable_collectives_backward(runs, dp, mp):
    out, _ = runs
    w = np.arange(1.0, 7.0)
    for r, rank_out in enumerate(out[dp, mp]):
        m = r % mp
        # MAX: channel 0 ties (rank 0 holds it), channel 1 is rank 1's,
        # channel 2 ties; the all-gather hands back this rank's weights;
        # the SUM passes 11 through.
        held = [m == 0, m == 1, m == 0]
        want = [7.0 * h + w[3 * m + i] + 11.0 for i, h in enumerate(held)]
        np.testing.assert_array_equal(rank_out["grad"], [want])


@pytest.mark.parametrize("sets,match", [
    (["data.num_points=2560", "model.pallas_chain_tile=256",
      "parallel.mp=4"], "leaves 640 points a rank, not a multiple of the "
                        "training chain's tile 256"),
    (["data.num_points=2560", "model.pallas_chain_tile=0",
      "model.pallas_tile=128", "model.decoder_kv_pool=3", "parallel.mp=4"],
     "leaves 640 points a rank, not a multiple of model.decoder_kv_pool=3"),
    (["parallel.dp=1", "parallel.mp=2"], "dp=1 x mp=2 = 2 ranks on a group "
                                         "of 4"),
])
def test_training_layout_refusals(sets, match):
    cfg = load_config(RECIPE, sets + ["train.batch_size=8"])
    with pytest.raises(ValueError, match=match):
        resolve_layout(cfg, 4, train=True)


@pytest.mark.parametrize("sets,want", [
    (["data.num_points=2560", "model.pallas_chain_tile=256",
      "parallel.mp=2"], (2, 2)),
    (["data.num_points=2560", "model.pallas_chain_tile=256",
      "parallel.mp=4"], None),
    # The plain chain (no Pallas encoder) has no tile to keep.
    (["data.num_points=2560", "model.use_pallas_encoder=false",
      "model.decoder_kv_pool=1", "parallel.mp=4"], (1, 4)),
])
def test_training_layout_accepts(sets, want):
    cfg = load_config(RECIPE, sets + ["train.batch_size=8"])
    if want is None:
        # mp = 4 at N = 2560 does not tile; outside training it resolves.
        assert resolve_layout(cfg, 4) == (1, 4)
        return
    assert resolve_layout(cfg, 4, train=True) == want


def _metrics(directory):
    with open(os.path.join(directory, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _targets_near_slots(cfg, flat, root):
    """Rewrite the .obj files of the batch `main` overfits on the corpus at
    `root` so that its targets sit 0.05 from distinct slots the model of
    `flat` predicts, as tests/test_torch_sharded_eval.py does: the
    matching then has a clear margin (ROADMAP C1)."""
    loader = BatchLoader(Building3DDataset(cfg.data, "train"),
                         cfg.train.batch_size, cfg.model.max_vertices,
                         shuffle=True, drop_last=True, seed=cfg.train.seed,
                         augment_on_host=False)
    loader.epoch = 0                        # as train_model sets it
    batch = next(iter(loader))
    model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(params_from_flax(flat), strict=True)
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["point_clouds"]),
                     torch.from_numpy(batch["vertex_counts"]),
                     train=True)["vertices"].numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    for i, c in enumerate(batch["vertex_counts"]):
        slots = rng.permutation(pred.shape[1])[:c]
        verts = batch["wf_vertices"][i].astype(np.float64)
        verts[:c] = pred[i, slots] + rng.normal(size=(c, 3)) * 0.05
        save_wireframe(verts * batch["max_distance"][i] + batch["centroid"][i],
                       batch["wf_edges"][i], os.path.join(
                           root, "train", "wireframe",
                           f"{batch['scan_idx'][i]}.obj"))


def test_torchrun_point_parallel_trains_as_one_process(tmp_path):
    root = str(tmp_path / "corpus")
    gen_main(["--out", root, "--train", "2", "--test", "1", "--seed", "4"])
    sets = MODELS["recipe"][1] + [
        "train.batch_size=2", "train.num_epochs=2", "data.augment=false",
        "train.overfit_one_batch=true", "train.log_every=1"]
    cfg = load_config(RECIPE, sets)
    cfg.data.root_dir = root
    flat = _spread(init_flax_params(cfg.model, 5))
    _targets_near_slots(cfg, flat, root)
    init = str(tmp_path / "init")
    write_flax_checkpoint(init, 0, flat, cfg)
    argv = (["--config", RECIPE, "--data-root", root, "--device", "cpu"]
            + [a for o in sets + [f"train.init_from={init}"]
               for a in ("--set", o)])
    one, two = str(tmp_path / "mp1"), str(tmp_path / "mp2")
    assert main_cli(argv + ["--checkpoint-dir", one]) == 0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
         "--master_port", str(_free_port()), "-m", "wireframe_tpu_torch.main",
         *argv, "--checkpoint-dir", two, "--set", "parallel.mp=2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Point-parallel training: mp=2" in proc.stderr
    want, got = _metrics(one), _metrics(two)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    assert want[0]["total_loss"] != want[1]["total_loss"]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if k != "elapsed_time":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
