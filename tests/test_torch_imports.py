"""The port stands alone and never runs quietly on the CPU.

- No module of wireframe_tpu_torch/, and not chip_smoke.py, imports jax,
  flax, optax, orbax, the JAX package wireframe_tpu or the repository's
  JAX scripts (main, evaluate, test, bench, visualize, tools,
  __graft_entry__): the port's CLIs keep their own copies.
- With no GPU, the entry points raise unless the caller passes
  device="cpu"; chip_smoke.py exits nonzero and prints no `ok` line.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "wireframe_tpu",
             "main", "evaluate", "test", "bench", "visualize", "tools",
             "__graft_entry__"}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT,
                                                  "wireframe_tpu_torch")):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 10
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                             & FORBIDDEN)
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_refuses_silent_cpu(no_cuda):
    from wireframe_tpu_torch.utils.platform import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from wireframe_tpu_torch import serve
    from wireframe_tpu_torch.bridge import (
        init_flax_params,
        save_port_checkpoint,
    )
    from wireframe_tpu_torch.config import load_config

    cfg = load_config(None, ["model.vertex_head=query",
                             "model.encoder_hidden_dims=16",
                             "model.encoder_output_dim=16",
                             "model.decoder_dim=16", "model.decoder_layers=1",
                             "model.decoder_heads=2",
                             "model.decoder_ffn_dim=16",
                             "model.edge_hidden_dim=16",
                             "model.edge_num_heads=2"])
    ckpt = str(tmp_path / "ckpt")
    save_port_checkpoint(ckpt, init_flax_params(cfg.model, 0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.WireframePredictor(ckpt)
    xyz = tmp_path / "a.xyz"
    np.savetxt(xyz, np.ones((5, 8)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([str(xyz), "--checkpoint-dir", ckpt, "--out-dir",
                    str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    # Asked for explicitly, the CPU serves.
    pred = serve.WireframePredictor(ckpt, device="cpu")
    assert pred.predict([np.random.default_rng(0).normal(size=(20, 8))])


def test_chip_smoke_fails_without_cuda(no_cuda, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out and '"ok"' not in out[-1]
    with pytest.raises(json.JSONDecodeError):
        json.loads(out[-1])
