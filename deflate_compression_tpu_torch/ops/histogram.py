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

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "tile_histogram.cu"
# a CTA's counters live in static-size dynamic shared memory (48 KB cap
# without the opt-in attribute)
MAX_CLASSES = 48 * 1024 // 4


def _load():
    return cuda_build.load(SOURCE, {"tile_histogram_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]})


def _check(sym: torch.Tensor, num_classes: int) -> None:
    if not isinstance(sym, torch.Tensor):
        raise TypeError("sym must be a torch.Tensor")
    if sym.dtype != torch.int32:
        raise TypeError(f"sym must be int32, got {sym.dtype}")
    if sym.dim() != 2:
        raise ValueError(f"sym must be 2-D (rows, length), got {tuple(sym.shape)}")
    if not sym.is_contiguous():
        raise ValueError("sym must be contiguous")
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}]")
    if sym.shape[0] > 2**31 - 1 or sym.shape[1] > 2**31 - 1:
        raise ValueError("sym too large for the kernel's int indexing")


def tile_histogram_ref(sym: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Plain PyTorch version: per-row bincount of the symbols in
    [0, num_classes); i32[rows, num_classes]."""
    rows = sym.shape[0]
    s = sym.long()
    s = torch.where((s >= 0) & (s < num_classes), s, num_classes)
    row = torch.arange(rows, device=sym.device).unsqueeze(1)
    flat = (row * (num_classes + 1) + s).reshape(-1)
    counts = torch.bincount(flat, minlength=rows * (num_classes + 1))
    return counts.view(rows, num_classes + 1)[:, :num_classes].to(torch.int32)


def tile_histogram(sym: torch.Tensor, num_classes: int) -> torch.Tensor:
    """out[r, c] = #{l : sym[r, l] == c} for c in [0, num_classes).

    sym: contiguous i32[rows, length]. A CUDA tensor goes through the CUDA
    kernel (or this raises); a CPU tensor through `tile_histogram_ref`."""
    _check(sym, num_classes)
    if sym.device.type == "cpu":
        return tile_histogram_ref(sym, num_classes)
    if sym.device.type != "cuda":
        raise ValueError(f"unsupported device {sym.device}")
    rows, length = sym.shape
    out = torch.empty((rows, num_classes), dtype=torch.int32,
                      device=sym.device)
    if rows == 0:
        return out
    lib = _load()
    with torch.cuda.device(sym.device):
        stream = torch.cuda.current_stream(sym.device).cuda_stream
        rc = lib.tile_histogram_launch(sym.data_ptr(), out.data_ptr(), rows,
                                       length, num_classes, stream)
    if rc != 0:
        raise RuntimeError(f"tile_histogram launch failed: cudaError {rc}")
    tile_histogram.launches += 1
    return out


tile_histogram.launches = 0
