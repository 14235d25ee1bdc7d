"""The benchmark imports neither JAX nor the JAX package, and its
reference imports nothing of the program (top-level names compared
whole: `wireframe_tpu_torch` is not `wireframe_tpu`)."""

import ast
import os

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "wireframe_tpu"}


def sources(under):
    for dirpath, _, files in os.walk(under):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(sources(PKG)),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources(os.path.join(
    PKG, "reference"))), ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert "wireframe_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "dataclasses", "math",
                     "typing", "numpy", "torch", "scipy", "port_bench"}


def test_reference_uses_only_the_reference_and_no_program_module():
    for path in sources(os.path.join(PKG, "reference")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("port_bench"):
                assert node.module.startswith("port_bench.reference")


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    from port_bench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "wireframe_tpu_torch_like",
                        types.ModuleType("wireframe_tpu_torch_like"))
    assert "wireframe_tpu_torch_like" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "wireframe_tpu.config",
                        types.ModuleType("wireframe_tpu.config"))
    assert "wireframe_tpu.config" in forbidden_modules()
