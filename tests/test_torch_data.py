"""The port's corpus generator, dataset and loaders against the JAX
package's.

- `wireframe_tpu_torch.tools.gen_demo_data` writes the same bytes in every
  `.xyz` and `.obj` file as `tools/gen_demo_data.py`, in both mixes.
- On one small corpus (written here), `Building3DDataset.get_sample`,
  `collate_fixed`, `BatchLoader` and `MixedBatchLoader` give batches
  `array_equal` to the JAX package's, key by key: over 2 shuffled epochs,
  with host augmentation on and off, with `z_sort_points` on and off, and
  resumed at `loader.epoch = 1`.  A worker's exception reaches the
  consumer in both.
"""

import filecmp
import os

import numpy as np
import pytest

from tools.gen_demo_data import main as jax_gen
from wireframe_tpu.config import DataConfig as JaxDataConfig
from wireframe_tpu.data.building3d import Building3DDataset as JaxDataset
from wireframe_tpu.data.building3d import collate_fixed as jax_collate
from wireframe_tpu.data.loader import BatchLoader as JaxBatchLoader
from wireframe_tpu.data.loader import MixedBatchLoader as JaxMixedLoader
from wireframe_tpu.ops.pairs import edge_labels_from_edges as jax_labels
from wireframe_tpu_torch.config import DataConfig
from wireframe_tpu_torch.data.building3d import (
    Building3DDataset,
    collate_fixed,
)
from wireframe_tpu_torch.data.loader import (
    ArrayBatchLoader,
    BatchLoader,
    MixedBatchLoader,
)
from wireframe_tpu_torch.ops.pairs import edge_labels_from_edges
from wireframe_tpu_torch.tools.gen_demo_data import main as port_gen

V = 16


def _same_tree(a, b):
    for split in ("train", "test"):
        for sub in ("xyz", "wireframe"):
            da, db = os.path.join(a, split, sub), os.path.join(b, split, sub)
            names = sorted(os.listdir(da))
            assert names == sorted(os.listdir(db)) and names
            match, mismatch, errors = filecmp.cmpfiles(da, db, names,
                                                       shallow=False)
            assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("mix", ["real", "uniform"])
def test_generator_writes_the_same_bytes(tmp_path, mix):
    argv = ["--train", "3", "--test", "2", "--seed", "0", "--mix", mix]
    assert port_gen(["--out", str(tmp_path / "port"), *argv]) == 0
    jax_gen(["--out", str(tmp_path / "jax"), *argv])
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    port_gen(["--out", str(root / "main"), "--train", "5", "--test", "2",
              "--seed", "3"])
    port_gen(["--out", str(root / "aux"), "--train", "3", "--test", "1",
              "--seed", "4", "--mix", "uniform"])
    return str(root / "main"), str(root / "aux")


def _configs(root, **kw):
    fields = dict(root_dir=root, num_points=256, max_vertices=V, **kw)
    return DataConfig(**fields), JaxDataConfig(**fields)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=k)
                assert np.asarray(a).dtype == np.asarray(b).dtype, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert np.asarray(g).dtype == np.asarray(w).dtype, k


def test_edge_labels_match():
    rng = np.random.default_rng(0)
    edges = rng.integers(-1, V + 2, size=(30, 2))
    np.testing.assert_array_equal(edge_labels_from_edges(edges, V),
                                  jax_labels(edges, V))
    np.testing.assert_array_equal(
        edge_labels_from_edges(np.empty((0, 2)), V),
        jax_labels(np.empty((0, 2)), V))


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("z_sort", [True, False])
def test_samples_and_collation_match(corpora, augment, z_sort):
    cfg, jcfg = _configs(corpora[0], z_sort_points=z_sort)
    ds, jds = Building3DDataset(cfg, "train"), JaxDataset(jcfg, "train")
    assert len(ds) == len(jds) == 5
    samples, jsamples = [], []
    for i in range(len(ds)):
        s = ds.get_sample(i, rng=np.random.default_rng(i),
                          augment_on_host=augment)
        js = jds.get_sample(i, rng=np.random.default_rng(i),
                            augment_on_host=augment)
        _assert_batches_equal(s, js)
        samples.append(s)
        jsamples.append(js)
    _assert_batches_equal(collate_fixed(samples, V),
                          jax_collate(jsamples, V))


@pytest.mark.parametrize("augment,z_sort", [(True, True), (False, False)])
def test_batch_loader_matches_over_epochs_and_resume(corpora, augment,
                                                     z_sort):
    cfg, jcfg = _configs(corpora[0], z_sort_points=z_sort)
    kw = dict(shuffle=True, drop_last=False, seed=11,
              augment_on_host=augment)
    loader = BatchLoader(Building3DDataset(cfg, "train"), 2, V, **kw)
    jloader = JaxBatchLoader(JaxDataset(jcfg, "train"), 2, V, **kw)
    assert len(loader) == len(jloader) == 3
    epochs = []
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        epochs.append(got)
    assert loader.epoch == jloader.epoch == 2
    assert not np.array_equal(epochs[0][0]["scan_idx"],
                              epochs[1][0]["scan_idx"]) or not np.array_equal(
        epochs[0][0]["point_clouds"], epochs[1][0]["point_clouds"])
    # A resumed loader replays epoch 1 exactly.
    resumed = BatchLoader(Building3DDataset(cfg, "train"), 2, V, **kw)
    resumed.epoch = 1
    for g, w in zip(resumed, epochs[1]):
        _assert_batches_equal(g, w)


def test_mixed_loader_matches(corpora):
    cfg, jcfg = _configs(corpora[0])
    acfg, ajcfg = _configs(corpora[1])
    kw = dict(shuffle=True, drop_last=True, seed=5, augment_on_host=True)
    loader = MixedBatchLoader(Building3DDataset(cfg, "train"),
                              Building3DDataset(acfg, "train"), 1, 3, V,
                              **kw)
    jloader = JaxMixedLoader(JaxDataset(jcfg, "train"),
                             JaxDataset(ajcfg, "train"), 1, 3, V, **kw)
    assert len(loader) == len(jloader) == 2
    for _ in range(2):
        for g, w in zip(loader, jloader):
            _assert_batches_equal(g, w)
    with pytest.raises(ValueError, match="aux_per_batch"):
        MixedBatchLoader(Building3DDataset(cfg, "train"),
                         Building3DDataset(acfg, "train"), 3, 3, V)


@pytest.mark.parametrize("prefetch", [2, 0])
def test_worker_exception_reaches_the_consumer(tmp_path, corpora, prefetch):
    import shutil

    root = tmp_path / "broken"
    shutil.copytree(corpora[0], root)
    victim = sorted((root / "train" / "xyz").iterdir())[2]
    victim.write_text("not a point cloud\n")
    cfg, jcfg = _configs(str(root))
    loader = BatchLoader(Building3DDataset(cfg, "train"), 2, V,
                         shuffle=False, prefetch=prefetch)
    jloader = JaxBatchLoader(JaxDataset(jcfg, "train"), 2, V,
                             shuffle=False, prefetch=prefetch)
    for ld in (loader, jloader):
        seen = []
        with pytest.raises(ValueError):
            for batch in ld:
                seen.append(batch)
        assert len(seen) == 1           # the batch before the bad file


def test_array_batch_loader_surface():
    batches = [{"point_clouds": np.zeros((4, 8, 8), np.float32)}] * 3
    loader = ArrayBatchLoader(batches)
    assert (len(loader), loader.batch_size, loader.drop_last) == (3, 4, False)
    assert len(list(loader)) == 3 and loader.epoch == 1


def test_train_model_refuses_an_empty_loader(corpora):
    """Fewer samples than a batch with drop_last: no batch, and
    train_model raises before it builds anything, as the JAX loop does."""
    from wireframe_tpu_torch.config import load_config
    from wireframe_tpu_torch.train.loop import train_model

    cfg, _ = _configs(corpora[0])
    loader = BatchLoader(Building3DDataset(cfg, "train"), 8, V)
    assert len(loader) == 0
    for overfit in ("true", "false"):
        run = load_config(None, [f"train.overfit_one_batch={overfit}"])
        with pytest.raises(ValueError, match="no batches"):
            train_model(run, loader, device="cpu")
