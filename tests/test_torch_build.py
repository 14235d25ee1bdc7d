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


def test_editing_an_included_header_changes_the_library(csrc_copy):
    names = ("fused_encoder", "chain_grad", "lockstep_lsa")
    before = {n: _build.library_path(n) for n in names}
    assert [p.name for p in _build._sources("chain_grad")] == [
        "chain_grad.cu", "wmma_gemm.cuh"]
    header = csrc_copy / "wmma_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["fused_encoder"] != before["fused_encoder"]
    assert after["chain_grad"] != before["chain_grad"]
    assert after["lockstep_lsa"] == before["lockstep_lsa"]


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
