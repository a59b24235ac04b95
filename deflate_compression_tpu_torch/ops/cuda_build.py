"""Build the CUDA sources of `csrc/` into shared libraries and load them.

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into `build/` beside this package. The
library's name carries a hash of the source, so an edited source is never
served from a stale build. A `Build` launches nvcc and returns at once, so
several sources can compile together; `load()` builds (or reuses) a
library and binds the named C functions through ctypes. The kernels'
wrappers pass `raw_stream()`'s handle, so each launch goes on PyTorch's
current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
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


def lib_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


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
