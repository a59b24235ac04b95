"""Build the CUDA sources of `csrc/` into shared libraries and load them.

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into `build/` beside this package. The
library's name carries a hash of the source and of the headers it
includes from its own folder (`#include "name.cuh"`), so an edited source
or header is never served from a stale build. A `Build` launches nvcc and returns at once, so
several sources can compile together; `load()` builds (or reuses) a
library and binds the named C functions through ctypes. The kernels'
wrappers pass `raw_stream()`'s handle, so each launch goes on PyTorch's
current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

_loaded: dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def lib_path(source: Path) -> Path:
    h = hashlib.sha256()
    seen, todo = set(), [source]
    while todo:                       # the source, then its local headers
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(text)
        todo += [path.parent / m.decode() for m in
                 _LOCAL_INCLUDE.findall(text)]
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


class Build:
    """One nvcc run, started on construction unless the library exists."""

    def __init__(self, source: Path):
        self.source = source
        self.path = lib_path(source)
        self._proc = None
        if self.path.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(self._tmp), str(source)]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)

    def wait(self) -> Path:
        if self._proc is not None:
            _, err = self._proc.communicate()
            rc = self._proc.returncode
            self._proc = None
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({rc}):\n{err}")
            os.replace(self._tmp, self.path)
        return self.path


def build(source: Path) -> Path:
    """Compile `source` if it is not built yet; return the library path."""
    return Build(source).wait()


def raw_stream():
    """A function of a device index that returns the handle of its current
    CUDA stream as an int (PyTorch's raw lookup where it has one)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        def raw(i):
            return torch.cuda.current_stream(i).cuda_stream
    return raw


_tickets: dict = {}


def ticket(dev: torch.device, stream: int) -> torch.Tensor:
    """A CTA counter (one uint32 in an int32 tensor) for kernels on this
    stream that let the CTA finishing last go on (`atomicInc`, wrapping to
    0): zeroed once and left at 0 by every launch, so launches on one
    stream, which run in turn, share it and launches on two streams never
    do."""
    t = _tickets.get((dev.index, stream))
    if t is None:
        t = _tickets[dev.index, stream] = torch.zeros(
            1, dtype=torch.int32, device=dev)
    return t


def card_scalar(x, data: torch.Tensor, what: str):
    """`x` as an int64 0-d tensor where it is a one-element integer tensor
    on a card, which must be data's, for a kernel to read there; None where
    it is no tensor on a card."""
    if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
        return None
    if x.device != data.device or x.numel() != 1:
        raise ValueError(f"{what} on {x.device} must be one element on "
                         f"data's device {data.device}")
    if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
        raise TypeError(f"{what} must be an integer, got {x.dtype}")
    return x.reshape(()).to(torch.int64)


def valid_length(valid_len, data: torch.Tensor):
    """(n, n as an int64 tensor on the card, or None) of `valid_len`: a
    one-element integer tensor on data's device stays there (n is then
    -1); anything else is an int in [0, len(data)]."""
    n_dev = card_scalar(valid_len, data, "valid_len")
    if n_dev is not None:
        return -1, n_dev
    size = data.shape[0]
    n = operator.index(valid_len)
    if not 0 <= n <= size:
        raise ValueError(f"valid_len {n} outside [0, {size}]")
    return n, None


def load(source: Path, functions: dict) -> ctypes.CDLL:
    """Build (or reuse) and load `source`'s library, giving each function
    named in `functions` its ctypes argtypes and an int return (the CUDA
    error code of its launch). A process loads each source once: later
    calls return the loaded library without reading the source again."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, argtypes in functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib
