"""CRC-32 (gzip's, zlib.crc32) of a byte tensor's first bytes on the card:
CUDA kernel wrapper.

The port's `core/checksum.py::crc32_torch` calls `crc32` for a CUDA tensor;
its plain version, `crc32_torch_ref`, stays there and takes CPU tensors. The
JAX package has no device CRC-32 (its `crc32_np` is host numpy). The kernel
(`csrc/crc32.cu`: one launch; each thread a run of 2^a 16-byte vectors by
slice-by-8 tables it builds in shared memory; runs and then segments joined
by multiplying by x^(2^m k) mod p(x), taken from `pow_table`; the last CTA,
by ticket, folds the segments) is built at first use by `ops/cuda_build.py`
and called through ctypes on PyTorch's current stream. The call copies
nothing from the host (the power table goes to each card once) and never
waits for the card: a length or a starting value held on the card is read
there by the kernel. `crc32.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "crc32.cu"
THREADS = 256                   # a CTA (csrc/crc32.cu: kThreads)
VEC_BYTES = 16                  # a thread's load
MAX_CTAS = 256                  # the last CTA folds one segment a thread
MAX_LOG2_VEC = 12               # a run is at most 4,096 vectors (64 KiB)
POW_ROWS = 28                   # rows of pow_table: x^(2^m k), m < 28
CTAS_PER_SM = 2
POLY = 0xEDB88320               # the reflected CRC-32 polynomial


def _mulmod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a(x) b(x) mod p(x) elementwise, reflected (bit 31 is x^0)."""
    a, b = a.astype(np.uint64), b.astype(np.uint64)
    p = np.zeros_like(a)
    for i in range(31, -1, -1):
        p ^= np.where((a >> np.uint64(i)) & np.uint64(1), b, np.uint64(0))
        b = (b >> np.uint64(1)) ^ np.where(b & np.uint64(1), np.uint64(POLY),
                                           np.uint64(0))
    return p


@functools.cache
def pow_table() -> np.ndarray:
    """u32[POW_ROWS, 256]: row m, column k holds x^(2^m k) mod p(x),
    reflected: what shifting a raw CRC register by k runs of 2^m bits
    multiplies it by."""
    row = np.zeros(256, np.uint64)
    v = 1 << 31                                   # x^0
    for k in range(256):
        row[k] = v
        v = (v >> 1) ^ POLY if v & 1 else v >> 1  # times x
    rows = [row]
    for _ in range(POW_ROWS - 1):
        rows.append(_mulmod(rows[-1], rows[-1]))
    return np.stack(rows).astype(np.uint32)


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_uint32)
    lib = cuda_build.load(SOURCE, {"crc32_launch": [
        vp, i64, vp, i64, u32, vp, i32, i32, vp, vp, vp, i32, vp]})
    return lib.crc32_launch, cuda_build.raw_stream()


_pows: dict = {}


def _pow_on(dev: torch.device) -> torch.Tensor:
    """pow_table on the card, copied there once."""
    t = _pows.get(dev.index)
    if t is None:
        t = _pows[dev.index] = torch.from_numpy(
            pow_table().view(np.int32)).to(dev)
    return t


@functools.cache
def target_ctas(index: int) -> int:
    """CTAS_PER_SM a streaming multiprocessor of CUDA device `index`, at
    most MAX_CTAS."""
    return min(MAX_CTAS, CTAS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count)


def grid(bound: int, target: int) -> tuple[int, int]:
    """(a, CTAs) for a CRC of at most `bound` bytes: runs of 2^a vectors a
    thread, the smallest a that keeps the CTAs (THREADS runs each) at most
    `target`, and enough CTAs to cover the bytes; at least one CTA."""
    nvec = max(1, -(-bound // VEC_BYTES))
    a = 0
    while -(-nvec // (THREADS << a)) > target:
        a += 1
    if a > MAX_LOG2_VEC:
        raise ValueError(f"{bound} bytes: more than the CRC-32 kernel takes")
    return a, -(-nvec // (THREADS << a))


def crc32(data: torch.Tensor, valid_len, init=0) -> torch.Tensor:
    """zlib.crc32(data[:valid_len], init) as an int64 0-d tensor on data's
    device, by one launch of the kernel. data: a 1-D contiguous uint8
    tensor on a CUDA device, at any byte address. valid_len: an int in
    [0, len(data)], or a one-element integer tensor on data's device, which
    the kernel reads there and clamps to [0, len(data)]. init: an int, or a
    one-element integer tensor on data's device (a CRC this function
    returned), read there."""
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8:
        raise TypeError("data must be a uint8 tensor")
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError(f"data must be 1-D and contiguous, got shape "
                         f"{tuple(data.shape)}, strides {data.stride()}")
    n, n_dev = cuda_build.valid_length(valid_len, data)
    v_dev = cuda_build.card_scalar(init, data, "init")
    v0 = 0 if v_dev is not None else operator.index(init) & 0xFFFFFFFF
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"the CRC-32 kernel runs on CUDA tensors, not on "
                         f"{dev}")
    size = data.shape[0]
    a, ctas = grid(size if n_dev is not None else n, target_ctas(dev.index))
    out = torch.empty(1 + ctas, dtype=torch.int64, device=dev)
    launch, stream = _bind()
    st = stream(dev.index)
    rc = launch(data.data_ptr(), n,
                None if n_dev is None else n_dev.data_ptr(), size, v0,
                None if v_dev is None else v_dev.data_ptr(), a, ctas,
                _pow_on(dev).data_ptr(), out.data_ptr(),
                cuda_build.ticket(dev, st).data_ptr(), dev.index, st)
    if rc != 0:
        raise RuntimeError(f"crc32 launch failed: cudaError {rc}")
    crc32.launches += 1
    return out[0]


crc32.launches = 0
