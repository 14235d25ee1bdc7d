"""What `ops/`'s nine kernel modules (each a plain version, a plan, a
signature table and a wrapper; `voxel` for the neighbour map) share: the
card's facts; the route (`on_card`); loading a library, typed and held to
its module's plans (`library`); the launch-error raise (`check`); the
16-byte row layouts; and one launch count.  A wrapper calls `count(key)`
once its launches returned without error, keyed by kernel: "K1" ... "K5
bwd", "LN rows fwd" / "LN rows bwd" (each with an " f32" twin), "K4" and
"K4 <variant>", "pair MLP", "subm conv", "neighbour map", "knn", "gva".
Counts tick on the host as a wrapper returns: under a CUDA graph, at
capture and never at a replay.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from wireframe_tpu_torch.ops import _build

SMS = 132               # streaming multiprocessors of one H100 SXM
SMEM_LIMIT = 232448     # dynamic shared memory one block may have (227 KB)

# ctypes of a signature's codes: a pointer, an int, a long long.
_CTYPES = {"P": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong}


def on_card(t: torch.Tensor, what: str) -> bool:
    """Whether `what` launches its kernel for `t`: False for a CPU tensor
    (the plain version), True for a CUDA tensor; any other device
    raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{what} runs on CUDA or CPU tensors, not {t.device}")


_libraries: Dict[str, ctypes.CDLL] = {}


def library(name: str, signatures: Mapping[str, str],
            self_check: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """`csrc/<name>.cu`'s library, built on first use, with each entry
    point of `signatures` typed from its signature (a code an argument,
    "->" and the return's code, an int when left out; `_CTYPES`), then
    held to the module's plans by `self_check(lib)`, which raises on a
    mismatch.  Once a process."""
    lib = _libraries.get(name)
    if lib is None:
        lib = _build.load(name)
        for fn_name, sig in signatures.items():
            args, _, ret = sig.partition("->")
            fn = getattr(lib, fn_name)
            fn.argtypes = [_CTYPES[c] for c in args]
            fn.restype = _CTYPES[ret or "i"]
        self_check(lib)
        _libraries[name] = lib
    return lib


def entry(lib: ctypes.CDLL, name: str, dtype):
    """The entry point `name` of `lib` for compute dtype `dtype`: its
    `_f32` twin for float32."""
    return getattr(lib, name + ("_f32" if dtype == torch.float32 else ""))


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def pad8(n: int) -> int:
    """Row stride, in elements, of a buffer read 16 bytes at a time (TMA
    or vector loads): 8 elements, 16-byte rows for bf16 and f32 alike."""
    return -(-n // 8) * 8


def row_buffer(m: int, width: int, dtype, dev) -> torch.Tensor:
    """An (m, width) buffer whose rows are pad8(width) apart."""
    return torch.empty((m, pad8(width)), dtype=dtype, device=dev)[:, :width]


def tma_rows(t: torch.Tensor, dtype) -> torch.Tensor:
    """t (rows, width) as `dtype` with rows a multiple of 8 elements apart
    and a 16-byte aligned start, as TMA reads it; copies only when t is
    not so already."""
    t = t.to(dtype)
    if (t.stride(-1) == 1 and t.stride(0) % 8 == 0
            and t.stride(0) >= t.shape[1] and t.data_ptr() % 16 == 0):
        return t
    out = row_buffer(t.shape[0], t.shape[1], dtype, t.device)
    out.copy_(t)
    return out


def aligned(t: torch.Tensor, dtype) -> torch.Tensor:
    """Contiguous `dtype` copy of a parameter whose pointer is 16-byte
    aligned (the kernels load 16-byte vectors)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def row_args(what: str, t: Optional[torch.Tensor], kernel: str):
    """(pointer, row stride) of a row-major buffer that `kernel` reads or
    writes 16 bytes at a time: its start and every row 16-byte aligned,
    or ValueError; (None, 0) for None."""
    if t is None:
        return None, 0
    if t.data_ptr() % 16 or t.stride(0) * t.element_size() % 16:
        raise ValueError(
            f"{what}: {kernel} reads rows 16 bytes at a time, from a "
            f"16-byte aligned start, rows a multiple of "
            f"{16 // t.element_size()} {t.dtype} elements apart; got a "
            f"start {t.data_ptr() % 16} bytes past 16 and rows "
            f"{t.stride(0)} elements apart")
    return t.data_ptr(), t.stride(0)


_counts: Dict[str, int] = {}


def count(key: str, dtype=None) -> None:
    """One call of the kernel `key` (its f32 twin, `key` + " f32", when
    `dtype` is float32) has launched without error."""
    if dtype == torch.float32:
        key += " f32"
    _counts[key] = _counts.get(key, 0) + 1


def launch_counts(keys: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """The counts since the last `reset_launches()`: every key counted, or
    with `keys` those keys, 0 where nothing was counted."""
    if keys is None:
        return dict(_counts)
    return {k: _counts.get(k, 0) for k in keys}


def reset_launches() -> None:
    _counts.clear()
