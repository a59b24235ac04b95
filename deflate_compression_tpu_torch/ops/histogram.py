"""Per-tile symbol histogram: CUDA kernel wrapper and its plain version.

Counterpart of deflate_compression_tpu/ops/histogram_pallas.py. The kernel
(`csrc/tile_histogram.cu`) is built at first use by `ops/cuda_build.py` and
called through ctypes on PyTorch's current stream.

`tile_histogram` launches the kernel for a CUDA tensor and raises if it
cannot; it takes the plain version `tile_histogram_ref` only for a tensor
that lies on the CPU. `tile_histogram.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "tile_histogram.cu"
# one copy of the counters fits the kernel's 48 KB of shared memory
MAX_CLASSES = 48 * 1024 // 4
DTYPES = (torch.int32, torch.int64)


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.load(SOURCE, {"tile_histogram_launch": [
        vp, vp, i32, ctypes.c_int64, i32, i32, i32, vp]})
    return lib.tile_histogram_launch, cuda_build.raw_stream()


def _check(sym: torch.Tensor, num_classes: int) -> None:
    if not isinstance(sym, torch.Tensor):
        raise TypeError("sym must be a torch.Tensor")
    if sym.dtype not in DTYPES:
        raise TypeError(f"sym must be int32 or int64, got {sym.dtype}")
    if sym.dim() != 2:
        raise ValueError(f"sym must be 2-D (rows, length), got {tuple(sym.shape)}")
    if not sym.is_contiguous():
        raise ValueError("sym must be contiguous")
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}]")
    if sym.shape[0] > 2**28 or sym.shape[1] > 2**31 - 1:
        raise ValueError("sym too large for the kernel's grid")


def tile_histogram_ref(sym: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Plain PyTorch version: per-row bincount of the symbols in
    [0, num_classes), in sym's type; [rows, num_classes]."""
    rows = sym.shape[0]
    s = sym.long()
    s = torch.where((s >= 0) & (s < num_classes), s, num_classes)
    row = torch.arange(rows, device=sym.device).unsqueeze(1)
    flat = (row * (num_classes + 1) + s).reshape(-1)
    counts = torch.bincount(flat, minlength=rows * (num_classes + 1))
    return counts.view(rows, num_classes + 1)[:, :num_classes].to(sym.dtype)


def tile_histogram(sym: torch.Tensor, num_classes: int) -> torch.Tensor:
    """out[r, c] = #{l : sym[r, l] == c} for c in [0, num_classes).

    sym: contiguous int32 or int64 [rows, length]; the counts come back in
    the same type. A CUDA tensor goes through the CUDA kernel (or this
    raises); a CPU tensor through `tile_histogram_ref`."""
    _check(sym, num_classes)
    dev = sym.device
    if dev.type == "cpu":
        return tile_histogram_ref(sym, num_classes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows, length = sym.shape
    out = torch.empty((rows, num_classes), dtype=sym.dtype, device=dev)
    if rows == 0:
        return out
    launch, stream = _bind()
    rc = launch(sym.data_ptr(), out.data_ptr(), rows, length, num_classes,
                sym.element_size(), dev.index, stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"tile_histogram launch failed: cudaError {rc}")
    tile_histogram.launches += 1
    return out


tile_histogram.launches = 0
