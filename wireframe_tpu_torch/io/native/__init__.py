"""ctypes bridge to the C++ `.xyz` parser (`fastparse.cpp`).

The port's copy of `wireframe_tpu/io/native`, with the same C ABI and
parser.  The shared library is built at first use with

    g++ -O3 -shared -fPIC

into `build/native/` at the repository root (listed in .gitignore), never
beside its source.  Its name carries a hash of the compiler flags and the
source, so an edited source is rebuilt and an unchanged one is loaded as
it is.  The build runs under a lock, so the loader's threads build once,
and lands by an atomic rename, so a concurrent process never loads half
a library.

A build or load failure is not silent: it warns once, with the
compiler's error, and `loaded()` stays False; `parse_xyz_native` then
returns None and `io.xyz.read_xyz` reads with `np.loadtxt`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "fastparse.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None     # why the library is not loaded, once tried


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                       + SRC.read_bytes())
    return BUILD_DIR / f"libfastparse-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The loaded parser library, built on first use; None (after one
    warning naming the error) when it cannot be built or loaded."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None or _ERROR is not None:
            return _LIB
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.parse_xyz.restype = ctypes.c_int
            lib.parse_xyz.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
            ]
            lib.free_xyz_buffer.restype = None
            lib.free_xyz_buffer.argtypes = [
                ctypes.POINTER(ctypes.c_double)]
            _LIB = lib
        except Exception as e:  # noqa: BLE001 - reported, then numpy reads
            _ERROR = f"{type(e).__name__}: {e}"
            warnings.warn(f"the native .xyz parser is unavailable, reading "
                          f"with np.loadtxt: {_ERROR}", RuntimeWarning,
                          stacklevel=2)
        return _LIB


def loaded() -> bool:
    """Whether the native library is loaded (tries to load it first)."""
    return load() is not None


def error() -> Optional[str]:
    """Why the library did not load, or None."""
    return _ERROR


def parse_xyz_native(path: str) -> Optional[np.ndarray]:
    """Parse with the C++ backend; None when the library is unavailable or
    the parser refuses the file (the caller falls back to numpy)."""
    lib = load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = lib.parse_xyz(os.fsencode(path), ctypes.byref(data),
                       ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
        return arr.reshape(rows.value, cols.value)
    finally:
        lib.free_xyz_buffer(data)
