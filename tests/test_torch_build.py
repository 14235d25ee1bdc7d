"""The kernel builder names each library by its sources, headers included.

`ops/_build.library_path` hashes the flags, `csrc/<name>.cu` and every
`csrc/` header it includes (recursively), so an edited header rebuilds
every kernel that includes it; a header it does not include changes
nothing.  Runs on copies of the sources in a temporary directory.
"""

import shutil

import pytest

from wireframe_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


@pytest.mark.parametrize("header, changed", [
    ("lockstep_lsa.cu", {"lockstep_lsa"}),
    ("hopper_gemm.cuh", {"chain_grad", "fused_encoder"})])
def test_editing_an_included_header_changes_the_library(csrc_copy, header,
                                                        changed):
    """An edited source rebuilds only its own library; an edited header,
    every library that includes it."""
    names = ("fused_encoder", "chain_grad", "lockstep_lsa")
    before = {n: _build.library_path(n) for n in names}
    path = csrc_copy / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert {n for n in names if after[n] != before[n]} == changed


@pytest.mark.parametrize("name, sources", [
    ("chain_grad", ["chain_grad.cu", "hopper_gemm.cuh"]),
    ("fused_encoder", ["fused_encoder.cu", "hopper_gemm.cuh"]),
    ("lockstep_lsa", ["lockstep_lsa.cu"])])
def test_sources_follow_the_includes(name, sources):
    """The chain kernels (K2 / K3 / K5) and K1 build on the wgmma + TMA
    GEMM of hopper_gemm.cuh; K4 stands alone."""
    assert [p.name for p in _build._sources(name)] == sources


def test_nested_and_missing_headers(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("// v1\n")
    (csrc_copy / "outer.cuh").write_text('#include "inner.cuh"\n')
    lsa = csrc_copy / "lockstep_lsa.cu"
    lsa.write_text('#include "outer.cuh"\n' + lsa.read_text())
    first = _build.library_path("lockstep_lsa")
    (csrc_copy / "inner.cuh").write_text("// v2\n")
    assert _build.library_path("lockstep_lsa") != first
    (csrc_copy / "inner.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="inner.cuh"):
        _build.library_path("lockstep_lsa")
