"""Table gather out[i] = tbl[idx[i]]: CUDA kernel wrapper and its plain
version.

Counterpart of the LUT gather that tools/probe_pallas_r5.py::try_lower
tried to lower as a Pallas TPU kernel. The decoder gathers each lane's
block flags with it (decode/device_inflate.py::lanes). The kernel
(`csrc/lut_gather.cu`) is built at first use by `ops/cuda_build.py` and
called through ctypes on PyTorch's current stream; it reads the table
through L1/L2, so any power-of-two table up to 2^30 entries goes.

`lut_gather` launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain version `lut_gather_ref` only for tensors that lie on the
CPU. `lut_gather.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "lut_gather.cu"
MAX_TABLE = 1 << 30


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {"lut_gather_launch": [
        vp, vp, vp, i64, i64, ctypes.c_int, vp]})
    return lib.lut_gather_launch, cuda_build.raw_stream()


def _check(tbl: torch.Tensor, idx: torch.Tensor) -> None:
    for name, t in (("tbl", tbl), ("idx", idx)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous")
    n = tbl.shape[0]
    if n < 1 or n > MAX_TABLE or n & (n - 1):
        raise ValueError(f"tbl size must be a power of two <= {MAX_TABLE}, "
                         f"got {n}")
    if tbl.device != idx.device:
        raise ValueError("tbl and idx must be on one device")


def lut_gather_ref(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: tbl[idx]."""
    return tbl[idx.long()]


def lut_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = tbl[idx[i]] for idx in [0, len(tbl)); tbl and idx are 1-D
    contiguous int32 on one device, len(tbl) a power of two up to 2^30.
    A CUDA tensor goes through the kernel (or this raises); a CPU tensor
    through `lut_gather_ref`."""
    _check(tbl, idx)
    dev = tbl.device
    if dev.type == "cpu":
        return lut_gather_ref(tbl, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    launch, stream = _bind()
    n = idx.shape[0]
    # out shares idx's offset from 16 bytes, so both vectorize together
    off = (idx.data_ptr() >> 2) & 3
    if off:
        out = torch.empty(n + off, dtype=torch.int32, device=dev)[off:]
    else:
        out = torch.empty_like(idx)
    rc = launch(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), tbl.shape[0],
                n, dev.index, stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"lut_gather launch failed: cudaError {rc}")
    if n:
        lut_gather.launches += 1
    return out


lut_gather.launches = 0

