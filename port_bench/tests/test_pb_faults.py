"""Runs of the cut cells with the timed path broken underneath: each
fault the cell can have makes `correct` false."""

import numpy as np
import pytest

from port_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", ["recipe-train-b8",
                                      "parity-train-b128"])
def test_state_left_unchanged(root, workload, capsys, monkeypatch):
    from wireframe_tpu_torch.train import state

    def apply(self, st, grads, g_norm=None):
        st.step += 1                      # counts the step, moves nothing

    monkeypatch.setattr(state.Optimizer, "apply", apply)
    res = tiny.run(root, workload, capsys=capsys)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["recipe-train-b8",
                                      "parity-train-b128"])
def test_half_of_the_batch_left_out(root, workload, capsys, monkeypatch):
    from wireframe_tpu_torch.train import step as step_mod

    make = step_mod.make_train_step

    def halved(cfg, *a, **k):
        inner = make(cfg, *a, **k)

        def train_step(state, batch, generator=None):
            b = batch["point_clouds"].shape[0] // 2
            return inner(state, {k: v[:b] for k, v in batch.items()},
                         generator)

        return train_step

    monkeypatch.setattr(step_mod, "make_train_step", halved)
    res = tiny.run(root, workload, capsys=capsys)
    assert not res["correct"], res["checks"]


def test_forward_answer_altered(root, capsys, monkeypatch):
    from wireframe_tpu_torch.train import step as step_mod

    make = step_mod.make_forward_fn

    def altered(cfg):
        inner = make(cfg)

        def forward(model, x, counts=None):
            out = dict(inner(model, x, counts))
            v = out["vertices"].clone()
            v[-1, 3, 1] += 0.1            # one slot of the batch's last cloud
            out["vertices"] = v
            return out

        return forward

    monkeypatch.setattr(step_mod, "make_forward_fn", altered)
    res = tiny.run(root, "recipe-infer-b512", capsys=capsys)
    assert not res["correct"]
    assert res["checks"]["vertex_gap"]["value"] >= 0.09


def test_served_answer_altered(root, capsys, monkeypatch):
    from wireframe_tpu_torch import serve

    decode = serve.decode_wireframe

    def altered(*a, **k):
        verts, edges = decode(*a, **k)
        verts = np.array(verts, copy=True)
        if len(verts):
            verts[0, 2] += 1e-3
        return verts, edges

    monkeypatch.setattr(serve, "decode_wireframe", altered)
    res = tiny.run(root, "recipe-serve-c1", capsys=capsys)
    assert not res["correct"]
    assert res["checks"]["decode_gap"]["value"] > 0
