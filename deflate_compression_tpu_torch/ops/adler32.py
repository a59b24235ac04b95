"""Adler-32 of a byte tensor's first bytes on the card: CUDA kernel wrapper.

The port's `core/checksum.py::adler32_torch` calls `adler32` for a CUDA
tensor; its plain version, `adler32_torch_ref`, stays there and takes CPU
tensors. The JAX package has no kernel for it (`core/checksum.py::
adler32_jax` is plain jnp). The kernel (`csrc/adler32.cu`: one launch,
about two CTAs an SM, each summing one segment exactly, the last CTA adding
the segments' shares mod 65521) is built at first use by `ops/cuda_build.py`
and called through ctypes on PyTorch's current stream. The call copies
nothing from the host and never waits for the card: a length held on the
card is read there by the kernel. `adler32.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "adler32.cu"
THREADS = 256                   # a CTA (csrc/adler32.cu: kThreads)
VEC_BYTES = 16                  # a thread's load
MAX_VEC = 256                   # loads a thread: a segment is at most 1 MiB
CTAS_PER_SM = 2


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {"adler32_launch": [
        vp, i64, vp, i64, i32, i32, vp, vp, i32, vp]})
    return lib.adler32_launch, cuda_build.raw_stream()


@functools.cache
def target_ctas(index: int) -> int:
    """CTAS_PER_SM a streaming multiprocessor of CUDA device `index`."""
    return CTAS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


def grid(bound: int, head: int, target: int) -> tuple[int, int]:
    """(16-byte loads a thread, CTAs) for a checksum of at most `bound`
    bytes from an address `head` bytes past a 16-byte boundary: the
    segments (THREADS x loads x 16 bytes, 4 KiB to 1 MiB) as small as
    keeps about `target` of them, and enough of them to cover the bytes;
    at least one CTA, which writes the result."""
    span = bound + head
    row = THREADS * VEC_BYTES
    vec = min(MAX_VEC, max(1, -(-span // (row * target))))
    return vec, max(1, -(-span // (row * vec)))


def adler32(data: torch.Tensor, valid_len) -> torch.Tensor:
    """Adler-32 of data[:valid_len] as an int64 0-d tensor on data's device,
    by one launch of the kernel. data: a 1-D contiguous uint8 tensor on a
    CUDA device, at any byte address (a slice of a batch's row is fine).
    valid_len: an int in [0, len(data)], or a one-element integer tensor on
    data's device, which the kernel reads there and clamps to
    [0, len(data)]."""
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8:
        raise TypeError("data must be a uint8 tensor")
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError(f"data must be 1-D and contiguous, got shape "
                         f"{tuple(data.shape)}, strides {data.stride()}")
    n, n_dev = cuda_build.valid_length(valid_len, data)
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"the Adler-32 kernel runs on CUDA tensors, not on "
                         f"{dev}")
    size = data.shape[0]
    ptr = data.data_ptr()
    vec, ctas = grid(size if n_dev is not None else n, ptr % VEC_BYTES,
                     target_ctas(dev.index))
    out = torch.empty(1 + ctas, dtype=torch.int64, device=dev)
    launch, stream = _bind()
    st = stream(dev.index)
    rc = launch(ptr, n, None if n_dev is None else n_dev.data_ptr(), size,
                vec, ctas, out.data_ptr(),
                cuda_build.ticket(dev, st).data_ptr(), dev.index, st)
    if rc != 0:
        raise RuntimeError(f"adler32 launch failed: cudaError {rc}")
    adler32.launches += 1
    return out[0]


adler32.launches = 0
