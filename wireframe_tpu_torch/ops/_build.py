"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/*.cu` file is compiled on first use, from the sources in this
package only, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v

into `build/kernels/` at the repository root (listed in .gitignore);
`-Xptxas=-v` only reports each kernel's registers and shared memory.  The
library name carries a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  The libraries have a
plain C interface: no PyTorch headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a host with the CUDA toolkit")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Tuple[Path, float, str]:
    """Compile `csrc/<name>.cu` unless its library exists.

    Returns (library path, build seconds (0 when cached), nvcc output).
    Raises RuntimeError with nvcc's output when the compile fails.
    """
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:"
                           f"\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    if name not in _loaded:
        path, _, _ = build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
