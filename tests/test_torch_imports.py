"""The port stands alone and never runs quietly on the CPU.

- No module of wireframe_tpu_torch/, and not chip_smoke.py, imports jax,
  flax, optax, orbax, the JAX package wireframe_tpu or the repository's
  JAX scripts (main, evaluate, test, bench, visualize, tools,
  __graft_entry__): the port's CLIs keep their own copies.
- No module outside wireframe_tpu_torch/viz/ imports matplotlib (the
  card's machine has none), and importing `viz` or `visualize` does not
  import it either: `viz.plots` is loaded on first use.
- With no GPU, the entry points raise unless the caller passes
  device="cpu"; chip_smoke.py exits nonzero and prints no `ok` line.
- The kernel modules of ops/ import downward only: none imports a
  sibling inside a function or a sibling's private name, the card's
  facts (`SMEM_LIMIT`, `SMS`) are assigned once, and each module imports
  on its own in a fresh interpreter.
"""

import ast
import json
import os
import subprocess
import sys

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
    # The measuring instruments are covered too.
    assert {os.path.join(ROOT, "wireframe_tpu_torch", p) for p in (
        "bench.py", "utils/profiling.py", "utils/trees.py",
        "tools/bench_latency.py", "tools/profile_train_step.py",
        "tools/trace_ops.py", "tools/compile_report.py")} <= set(sources)
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                             & FORBIDDEN)
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}


def test_only_viz_imports_matplotlib():
    viz = os.path.join(ROOT, "wireframe_tpu_torch", "viz")
    users = {os.path.relpath(p, ROOT) for p in _port_sources()
             if "matplotlib" in set(_imported_roots(p))}
    assert users == {"wireframe_tpu_torch/viz/plots.py"}
    assert os.path.dirname(os.path.join(ROOT, sorted(users)[0])) == viz
    code = ("import sys, wireframe_tpu_torch, wireframe_tpu_torch.viz, "
            "wireframe_tpu_torch.visualize, wireframe_tpu_torch.main; "
            "assert 'matplotlib' not in sys.modules, 'imported'; "
            "from wireframe_tpu_torch.viz import plot_wireframe; "
            "assert 'matplotlib' in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


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


@pytest.mark.parametrize("tool", ["bench", "tools.bench_latency",
                                  "tools.profile_train_step",
                                  "tools.trace_ops", "tools.compile_report"])
def test_measuring_tools_raise_without_cuda(no_cuda, tool, tmp_path):
    import importlib

    module = importlib.import_module(f"wireframe_tpu_torch.{tool}")
    argv = ["--out", str(tmp_path / "lat.md")] if "latency" in tool else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert not (tmp_path / "lat.md").exists()


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


OPS = os.path.join(ROOT, "wireframe_tpu_torch", "ops")
KERNEL_MODULES = ("_launch", "hopper_gemm", "layernorm_rows",
                  "fused_encoder", "chain_grad", "lockstep_lsa", "pair_mlp",
                  "subm_conv")


def _ops_tree(name):
    path = os.path.join(OPS, name + ".py")
    return ast.parse(open(path).read(), filename=path)


def _sibling(node):
    """The ops/ module an import node names, or None."""
    if isinstance(node, ast.ImportFrom) and node.module:
        mods = [node.module] + [f"{node.module}.{a.name}"
                                for a in node.names]
    elif isinstance(node, ast.Import):
        mods = [a.name for a in node.names]
    else:
        return None
    for mod in mods:
        if mod.startswith("wireframe_tpu_torch.ops."):
            return mod.split(".")[2]
    return None


def test_kernel_modules_import_downward_only():
    bad = []
    for name in KERNEL_MODULES:
        tree = _ops_tree(name)
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if _sibling(node):
                    bad.append((name, fn.name, _sibling(node)))
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.startswith("wireframe_tpu_torch.ops.")):
                bad += [(name, node.module, a.name) for a in node.names
                        if a.name.startswith("_")]
    assert not bad


def test_card_facts_are_assigned_once():
    where = {"SMEM_LIMIT": [], "SMS": []}
    for fname in sorted(os.listdir(OPS)):
        if not fname.endswith(".py"):
            continue
        for node in ast.walk(_ops_tree(fname[:-3])):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in where:
                        where[t.id].append(fname)
    assert where == {"SMEM_LIMIT": ["_launch.py"], "SMS": ["_launch.py"]}


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_kernel_module_imports_alone(name):
    proc = subprocess.run(
        [sys.executable, "-c", f"import wireframe_tpu_torch.ops.{name}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
