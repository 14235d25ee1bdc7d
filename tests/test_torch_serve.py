"""The port's serving path against the JAX WireframePredictor.

Same weights (an orbax checkpoint for JAX, the bridged npz for the
port), same raw clouds, including one that is downsampled to the largest
bucket: the decoded wireframes must agree.  The recipe architecture runs
at small width in f32, where the two models agree to ~1e-6, so:
- live slots and edge sets are equal, excluding edges whose probability
  lies within 1e-4 of the threshold (none did when this was written);
- world-coordinate vertices agree to 1e-4 (the clouds' frame is UTM-like,
  ~5e5 m, with a radius of a few metres).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.models.wireframe import PointCloudToWireframe as JaxModel
from wireframe_tpu.serve import WireframePredictor as JaxPredictor
from wireframe_tpu.train.checkpoint import save_checkpoint
from wireframe_tpu_torch import serve
from wireframe_tpu_torch.bridge import flatten_params, save_port_checkpoint
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.io.obj import load_wireframe
from wireframe_tpu_torch.ops.pairs import triu_pairs_np

RECIPE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "recommended.yaml")
OVERRIDES = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
             "model.decoder_dim=32", "model.decoder_layers=2",
             "model.decoder_heads=4", "model.decoder_ffn_dim=64",
             "data.max_vertices=8", "model.edge_hidden_dim=32",
             "model.edge_num_heads=4", "model.pallas_tile=32",
             "model.compute_dtype=float32", "data.point_buckets=64,128",
             "eval.batch_size=2"]
VERTEX_ATOL = 1e-4
EDGE_MARGIN = 1e-4
OFFSET = (534000.0, 6588000.0, 45.0)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of weights as an orbax checkpoint and as a port checkpoint.
    Biases and slot queries are randomized: flax's init makes every slot
    nearly the same, which would leave nothing to compare.  The last edge
    bias is raised so that edge probabilities straddle the recipe's 0.4
    threshold."""
    cfg = jax_load_config(RECIPE, OVERRIDES)
    x = jnp.zeros((1, 64, cfg.model.input_dim), jnp.float32)
    init_cfg = jax_load_config(RECIPE, OVERRIDES
                               + ["model.use_pallas_encoder=false"])
    params = jax.jit(lambda key: JaxModel(init_cfg.model).init(
        {"params": key}, x, None, train=False)["params"])(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(11)

    def perturb(path, v):
        name = path[-1].key
        if path[-2].key == "Dense_5" and name == "bias":
            return v + np.float32(0.45)
        if name == "slot_queries":
            return rng.normal(size=v.shape).astype(np.float32)
        if name in ("bias",) or name.endswith("_b"):
            return (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(perturb, params)
    d = tmp_path_factory.mktemp("torch_serve")
    save_checkpoint(str(d / "jax"), 1, params, cfg=cfg)
    save_port_checkpoint(str(d / "port"), flatten_params(params),
                         load_config(RECIPE, OVERRIDES))
    return str(d / "jax"), str(d / "port")


@pytest.fixture(scope="module")
def predictors(checkpoints):
    jax_dir, port_dir = checkpoints
    jp = JaxPredictor(jax_dir, config=RECIPE, overrides=OVERRIDES,
                      cache_dir="")
    pp = serve.WireframePredictor(port_dir, config=RECIPE,
                                  overrides=OVERRIDES, device="cpu")
    return jp, pp


def _raw_cloud(rng, n, offset=OFFSET, scale=3.0):
    pc = np.zeros((n, 8))
    pc[:, :3] = rng.normal(size=(n, 3)) * scale + np.asarray(offset)
    pc[:, 3:7] = rng.uniform(0, 255, size=(n, 4))
    pc[:, 7] = rng.uniform(40000, 50000, size=n)
    return pc


def _ambiguous_edges(pp, cloud):
    """Live-index edges whose probability is within EDGE_MARGIN of the
    threshold, from the port's raw outputs for this cloud."""
    pc = pp._preprocess(cloud)["pc"]
    bucket = next(iter(pp.batch_plan([pc.shape[0]])))
    raw = pp._forward(pp.batch_array([pc], bucket))
    p_exist = raw["existence_probabilities"][0]
    assert np.all(np.abs(p_exist - pp.cfg.eval.vertex_existence_thresh)
                  > EDGE_MARGIN), "an existence probability sits on 0.5"
    live = p_exist > pp.cfg.eval.vertex_existence_thresh
    remap = -np.ones(len(live), np.int64)
    remap[live] = np.arange(live.sum())
    pairs = triu_pairs_np(len(live))
    near = np.abs(raw["edge_probs"][0]
                  - pp.cfg.eval.edge_confidence_thresh) <= EDGE_MARGIN
    keep = near & live[pairs[:, 0]] & live[pairs[:, 1]]
    return {tuple(e) for e in remap[pairs[keep]]}


def test_same_wireframes_as_jax(predictors, rng):
    jp, pp = predictors
    sizes = (40, 64, 100, 128, 300)       # 300 > 128: downsampled
    clouds = [_raw_cloud(rng, n) for n in sizes]
    want = jp.predict(clouds)
    got = pp.predict(clouds)
    total_edges = 0
    for cloud, w, g in zip(clouds, want, got):
        assert g["num_vertices"] == w["num_vertices"]
        np.testing.assert_allclose(g["vertices"], w["vertices"], rtol=0,
                                   atol=VERTEX_ATOL)
        amb = _ambiguous_edges(pp, cloud)
        assert ({tuple(e) for e in g["edges"]} - amb
                == {tuple(e) for e in w["edges"]} - amb)
        total_edges += w["num_edges"]
    assert total_edges > 0 and any(w["num_vertices"] for w in want)


def test_batch_padding_does_not_change_outputs(predictors, rng):
    _, pp = predictors
    cloud = _raw_cloud(rng, 64)
    alone = pp.predict([cloud])[0]
    together = pp.predict([cloud, _raw_cloud(rng, 64),
                           _raw_cloud(rng, 100)])[0]
    np.testing.assert_allclose(alone["vertices"], together["vertices"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(alone["edges"], together["edges"])


def test_predict_files_writes_obj(predictors, rng, tmp_path):
    from wireframe_tpu.io.obj import load_wireframe as jax_load_wireframe

    jp, pp = predictors
    paths = []
    for i, n in enumerate((80, 200)):
        p = tmp_path / f"{i}.xyz"
        np.savetxt(p, _raw_cloud(rng, n), fmt="%.4f")
        paths.append(str(p))
    got = pp.predict_files(paths, out_dir=str(tmp_path / "obj"))
    want = jp.predict_files(paths)
    for g, w in zip(got, want):
        verts, edges = load_wireframe(g["obj_path"])
        np.testing.assert_array_equal(verts, g["vertices"])
        np.testing.assert_array_equal(edges, np.sort(g["edges"], axis=1))
        jv, je = jax_load_wireframe(g["obj_path"])
        np.testing.assert_array_equal(jv, verts)
        np.testing.assert_array_equal(je, edges)
        assert g["num_vertices"] == w["num_vertices"]


def test_geometry_only_input(predictors, rng):
    """(N, 3) clouds are accepted: non-XYZ channels zero-filled."""
    jp, pp = predictors
    cloud = rng.normal(size=(50, 3)) * 2.0
    g, w = pp.predict([cloud])[0], jp.predict([cloud])[0]
    assert g["vertices"].shape[1] == 3
    assert g["num_vertices"] == w["num_vertices"]
    np.testing.assert_allclose(g["vertices"], w["vertices"], rtol=0,
                               atol=VERTEX_ATOL)


def test_cli_writes_world_coordinate_obj(checkpoints, rng, tmp_path):
    _, port_dir = checkpoints
    xyz = tmp_path / "7.xyz"
    np.savetxt(xyz, _raw_cloud(rng, 90), fmt="%.4f")
    out = tmp_path / "pred"
    serve.main([str(xyz), "--checkpoint-dir", port_dir, "--out-dir",
                str(out), "--config", RECIPE, "--device", "cpu",
                *[a for ov in OVERRIDES for a in ("--set", ov)]])
    verts, _ = load_wireframe(str(out / "7.obj"))
    if len(verts):
        assert np.linalg.norm(verts.mean(0) - np.asarray(OFFSET)) < 100.0


def test_xyz_and_obj_io_match_jax(rng, tmp_path):
    from wireframe_tpu.io import obj as jax_obj
    from wireframe_tpu.io import xyz as jax_xyz
    from wireframe_tpu_torch.io import obj, xyz

    p = tmp_path / "c.xyz"
    np.savetxt(p, _raw_cloud(rng, 30), fmt="%.4f")
    np.testing.assert_array_equal(xyz.read_xyz(str(p)),
                                  jax_xyz.read_xyz(str(p)))
    raw = xyz.read_xyz(str(p))
    for flags in ((True, True, True), (True, False, False),
                  (False, True, True), (False, False, False)):
        np.testing.assert_array_equal(xyz.select_features(raw, *flags),
                                      jax_xyz.select_features(raw, *flags))
    verts = rng.normal(size=(5, 3))
    edges = np.array([[0, 1], [3, 2], [1, 0], [4, 0]])
    obj.save_wireframe(verts, edges, str(tmp_path / "a.obj"))
    jax_obj.save_wireframe(verts, edges, str(tmp_path / "b.obj"))
    assert (tmp_path / "a.obj").read_text() == (tmp_path / "b.obj").read_text()
    for a, b in zip(obj.load_wireframe(str(tmp_path / "a.obj")),
                    jax_obj.load_wireframe(str(tmp_path / "a.obj"))):
        np.testing.assert_array_equal(a, b)


def test_decode_and_bucketing_match_jax(rng):
    from wireframe_tpu.data import bucketing as jax_bucketing
    from wireframe_tpu.eval.evaluator import decode_predictions as jax_decode
    from wireframe_tpu.ops import pairs as jax_pairs
    from wireframe_tpu_torch.data import bucketing
    from wireframe_tpu_torch.eval.decode import decode_predictions
    from wireframe_tpu_torch.ops import pairs

    v = 8
    np.testing.assert_array_equal(pairs.triu_pairs_np(v),
                                  jax_pairs.triu_pairs_np(v))
    i, j = pairs.triu_pairs_np(v).T
    np.testing.assert_array_equal(pairs.pair_slot(i, j, v),
                                  np.asarray(jax_pairs.pair_slot(i, j, v)))
    verts = rng.normal(size=(v, 3))
    probs = rng.uniform(size=v * (v - 1) // 2)
    live = rng.uniform(size=v) > 0.4
    for kw in (dict(live_mask=live), {}):
        a = decode_predictions(verts, probs, 5, v, 0.4, **kw)
        b = jax_decode(verts, probs, 5, v, 0.4, **kw)
        for key in ("vertices", "edges", "edges_vertices"):
            np.testing.assert_array_equal(a[key], b[key])
    pc = rng.normal(size=(50, 8)).astype(np.float32)
    pc[40:] = 0.0
    for bucket in (64, 32):
        a = bucketing.pad_or_sample(pc, bucket, np.random.default_rng(3))
        b = jax_bucketing.pad_or_sample(pc, bucket, np.random.default_rng(3))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(bucketing.z_sort_rows(a),
                                      jax_bucketing.z_sort_rows(b))
    assert bucketing.choose_bucket(50, (64, 32)) == 64
    assert bucketing.choose_bucket(500, (64, 32)) == 64
