"""Length-limited canonical Huffman codes: CUDA kernel wrapper and its
plain version.

Counterpart of deflate_compression_tpu/core/huffman.py::huffman_code_lengths
with _package_merge_lengths (:75-192) and canonical_codes, and
core/bits.py::reverse_bits (:30-44), which the JAX package left to XLA:
they have no Pallas kernel. For B independent alphabets at once: the
optimal code lengths under a length limit (package-merge, a leaf before a
package of equal weight), the RFC 1951 canonical codes and each code
bit-reversed within its length, as the LSB-first stream writes it.

The kernel (`csrc/huffman_codes.cu`: one CTA per alphabet, a thread per
symbol, int32 lists of the used symbols below 2^28 only) is built at first
use by `ops/cuda_build.py` and called through ctypes on PyTorch's
current stream. `huffman_codes` launches it for a CUDA tensor and raises if
it cannot; it takes the plain version `huffman_codes_ref` (today's three
functions of core/huffman.py and core/bits.py, composed unchanged) only for
a tensor that lies on the CPU. `huffman_codes.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.bits import reverse_bits
from ..core.huffman import canonical_codes, huffman_code_lengths
from . import cuda_build

SOURCE = cuda_build.CSRC / "huffman_codes.cu"
MAX_SYMBOLS = 512                # one thread per symbol
MAX_BITS = 15


class Codes(NamedTuple):
    """int64 (B, n) each: code lengths, canonical codes (MSB-first) and the
    codes bit-reversed within their lengths."""
    lengths: torch.Tensor
    codes: torch.Tensor
    rev: torch.Tensor


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.load(SOURCE, {"huffman_codes_launch": [
        vp, i32, i32, i32, vp, vp, vp, i32, vp]})
    return lib.huffman_codes_launch, cuda_build.raw_stream()


def _check(freqs: torch.Tensor, max_bits: int) -> None:
    if not isinstance(freqs, torch.Tensor):
        raise TypeError("freqs must be a torch.Tensor")
    if freqs.dtype != torch.int64:
        raise TypeError(f"freqs must be int64, got {freqs.dtype}")
    if freqs.dim() != 2 or not 1 <= freqs.shape[1] <= MAX_SYMBOLS:
        raise ValueError(f"freqs must be (B, n) with 1 <= n <= "
                         f"{MAX_SYMBOLS}, got {tuple(freqs.shape)}")
    if freqs.shape[0] > 2**31 - 1:
        raise ValueError("more alphabets than the kernel's grid takes")
    if not freqs.is_contiguous():
        raise ValueError("freqs must be contiguous")
    if not 1 <= max_bits <= MAX_BITS:
        raise ValueError(f"max_bits must be in [1, {MAX_BITS}]")


def huffman_codes_ref(freqs: torch.Tensor, max_bits: int) -> Codes:
    """Plain PyTorch version of the kernel. Arguments and result as for
    `huffman_codes`."""
    lengths = huffman_code_lengths(freqs, max_bits)
    codes = canonical_codes(lengths, max_bits)
    return Codes(lengths, codes, reverse_bits(codes, lengths, max_bits))


def huffman_codes(freqs: torch.Tensor, max_bits: int) -> Codes:
    """Codes of at most `max_bits` bits for each row of freqs (B, n),
    contiguous int64 below 2^62; a symbol is used where its frequency is
    positive. Among used symbols a lower frequency never gets a shorter
    code, ties by symbol index; one used symbol gets length 1. A CUDA
    tensor goes through the CUDA kernel (or this raises); a CPU tensor
    through `huffman_codes_ref`."""
    _check(freqs, max_bits)
    dev = freqs.device
    if dev.type == "cpu":
        return huffman_codes_ref(freqs, max_bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, n = freqs.shape
    out = torch.empty((3, B, n), dtype=torch.int64, device=dev)
    if B == 0:
        return Codes(*out)
    launch, stream = _bind()
    rc = launch(freqs.data_ptr(), B, n, max_bits, out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), dev.index,
                stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"huffman_codes launch failed: cudaError {rc}")
    huffman_codes.launches += 1
    return Codes(*out)


huffman_codes.launches = 0
