"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/*.cu` file is compiled on first use, from the sources in this
package only, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v

into `build/kernels/` at the repository root (listed in .gitignore);
`-Xptxas=-v` only reports each kernel's registers and shared memory.  The
library name carries a hash of the flags, the source and every `csrc/`
header it includes (`#include "x.cuh"`, followed recursively), so an
edited source or header is rebuilt and an unchanged one is loaded as it
is.  The libraries have a plain C interface: no PyTorch headers, so a
build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` and the `csrc/` headers it includes, recursively,
    in a fixed order."""
    out: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = (path.parent / inc.decode()).resolve()
            if not header.is_file():
                raise FileNotFoundError(f"{path.name} includes {header}, "
                                        "which does not exist")
            todo.append(header)
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Compile every `csrc/<name>.cu` whose library does not exist yet,
    one `nvcc` process per source, all started together.

    Returns {name: (library path, build seconds (0 when cached), nvcc
    output)}.  Raises RuntimeError with nvcc's output when a compile fails.
    """
    results: Dict[str, Tuple[Path, float, str]] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = (out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}) for {name}.cu:"
                            f"\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        results[name] = (out, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    if name not in _loaded:
        path, _, _ = build_all([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
