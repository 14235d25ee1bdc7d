"""The port's C++ `.xyz` parser (`wireframe_tpu_torch/io/native`) against
the JAX package's (`wireframe_tpu/io/native`) and `np.loadtxt`.

Tolerance: none.  The three readers give `array_equal` float64 arrays.
The C parser refuses a ragged file (`fastparse.cpp`'s per-line field
count), and the port's `read_xyz` then reads with numpy, as the JAX
package's does.  The library is built under `build/native/` at the
repository root, never beside its source.
"""

import os
import warnings
from pathlib import Path

import numpy as np
import pytest

from wireframe_tpu.io.native import parse_xyz_native as jax_parse
from wireframe_tpu.io.xyz import read_xyz as jax_read_xyz
from wireframe_tpu_torch.io import native, xyz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, name, text):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(text)
    return path


def _three(path):
    got = native.parse_xyz_native(path)
    assert got is not None
    want = np.loadtxt(path, dtype=np.float64, ndmin=2)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_parse(path))
    return got


def test_generator_clouds_parse_identically(tmp_path):
    from wireframe_tpu_torch.tools.gen_demo_data import main as gen

    gen(["--out", str(tmp_path / "corp"), "--train", "3", "--test", "1",
         "--seed", "0", "--mix", "real"])
    paths = sorted(str(p) for p in (tmp_path / "corp").rglob("*.xyz"))
    assert len(paths) == 4
    for path in paths:
        got = _three(path)
        assert got.shape[1] == 8 and got.shape[0] > 1000
        np.testing.assert_array_equal(xyz.read_xyz(path), got)


@pytest.mark.parametrize("name, text", [
    ("scientific", "1e3 -2.5E-2 3.0e+0\n4.5e-7 5 -6E2\n"),
    ("blank_lines", "\n\n1 2 3\n\n4 5 6\n\n\n"),
    ("trailing_whitespace", "1 2 3  \t\n4 5 6 \n"),
    ("no_final_newline", "1.25 2 3\n4 5 6.5"),
    ("crlf", "1 2 3\r\n4 5 6\r\n"),
    ("one_row", "534123.456 6590000.125 42.5 128 64 32 255 47000\n"),
    ("wide_random", None),
])
def test_text_forms_parse_identically(tmp_path, name, text):
    if text is None:
        rng = np.random.default_rng(0)
        data = rng.normal(size=(300, 8)) * 10.0 ** rng.integers(
            -6, 7, size=(300, 8))
        path = str(tmp_path / f"{name}.xyz")
        np.savetxt(path, data, fmt="%.17g")
    else:
        path = _write(tmp_path, f"{name}.xyz", text)
    _three(path)


def test_ragged_file_goes_to_numpy_in_both_packages(tmp_path):
    # A comment line: np.loadtxt skips it; the C parser counts its tokens
    # as the column count and refuses the rows that follow.
    path = _write(tmp_path, "comment.xyz", "# 1 2\n1 2 3\n4 5 6\n")
    assert native.parse_xyz_native(path) is None
    assert jax_parse(path) is None
    before = dict(xyz.READS)
    got = xyz.read_xyz(path)
    assert xyz.READS["numpy"] == before["numpy"] + 1
    assert xyz.READS["native"] == before["native"]
    np.testing.assert_array_equal(got, jax_read_xyz(path))
    np.testing.assert_array_equal(got, [[1.0, 2, 3], [4, 5, 6]])
    # Compensating ragged rows (3, 2, 4 fields): refused by both C
    # parsers, and numpy refuses them too, in both packages alike.
    path = _write(tmp_path, "ragged.xyz", "1 2 3\n4 5\n6 7 8 9\n")
    assert native.parse_xyz_native(path) is None
    assert jax_parse(path) is None
    with pytest.raises(ValueError):
        xyz.read_xyz(path)
    with pytest.raises(ValueError):
        jax_read_xyz(path)


def test_use_native_false_reads_with_numpy(tmp_path):
    path = _write(tmp_path, "a.xyz", "1 2 3\n4 5 6\n")
    before = xyz.READS["numpy"]
    np.testing.assert_array_equal(xyz.read_xyz(path, use_native=False),
                                  [[1.0, 2, 3], [4, 5, 6]])
    assert xyz.READS["numpy"] == before + 1


def test_library_builds_under_build_not_in_the_package():
    assert native.loaded(), native.error()
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR == Path(ROOT, "build", "native")
    pkg = os.path.join(ROOT, "wireframe_tpu_torch")
    found = [os.path.join(d, n) for d, _, names in os.walk(pkg)
             for n in names if n.endswith(".so")]
    assert found == []


def test_build_failure_warns_once_and_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "fastparse.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    path = _write(tmp_path, "a.xyz", "1 2 3\n4 5 6\n")
    with pytest.warns(RuntimeWarning, match="g\\+\\+ failed"):
        got = xyz.read_xyz(path)
    np.testing.assert_array_equal(got, [[1.0, 2, 3], [4, 5, 6]])
    assert not native.loaded()
    assert native.error().startswith("RuntimeError: g++ failed")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        xyz.read_xyz(path)          # no second warning
    assert not list((tmp_path / "native").glob("*.so"))


def test_library_name_hashes_source_and_flags(tmp_path, monkeypatch):
    first = native.library_path()
    src = tmp_path / "fastparse.cpp"
    src.write_bytes(native.SRC.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native, "SRC", src)
    second = native.library_path()
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O2", "-shared", "-fPIC"))
    third = native.library_path()
    assert len({first.name, second.name, third.name}) == 3


def test_parallel_loader_threads_build_once(tmp_path, monkeypatch):
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    builds = []
    real_build = native._build
    monkeypatch.setattr(native, "_build",
                        lambda out: (builds.append(out), real_build(out)))
    path = _write(tmp_path, "a.xyz", "1 2 3\n4 5 6\n")
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda _: native.parse_xyz_native(path),
                             range(16)))
    assert len(builds) == 1
    assert [p.name for p in (tmp_path / "native").iterdir()] == [
        native.library_path().name]
    for out in outs:
        np.testing.assert_array_equal(out, [[1.0, 2, 3], [4, 5, 6]])
