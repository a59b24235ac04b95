"""Bitstream primitives (counterpart of deflate_compression_tpu/core/bits.py).

Serialization is an array of items (value, nbits, absolute bit offset)
packed into LSB-first 32-bit words. Items occupy disjoint bits, so an
integer `index_add_` of their word contributions equals their OR. Words
are int64 tensors holding u32 values (core/u32.py). `BitReader` is the
host-side reader of the decode-index pass, copied from the JAX module.
"""
from __future__ import annotations

import numpy as np
import torch

from .u32 import low_mask, shl32


def reverse_bits(codes: torch.Tensor, nbits: torch.Tensor,
                 max_bits: int = 15) -> torch.Tensor:
    """Bit-reverse each code within its own width `nbits`."""
    c = codes.long()
    nb = nbits.long()
    r = torch.zeros_like(c)
    for i in range(max_bits):
        bit = (c >> i) & 1
        shift = nb - 1 - i
        r = r | torch.where(shift >= 0, bit << shift.clamp(min=0), 0)
    return r


def _add_dropping(out: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> None:
    """out[idx] += val, dropping indices outside [0, len(out) - 1): the
    last slot of `out` is a discard slot (JAX scatter's drop mode)."""
    trash = out.shape[0] - 1
    idx = torch.where((idx >= 0) & (idx < trash), idx, trash)
    out.index_add_(0, idx, val)


def pack_items64_to_words(lo: torch.Tensor, hi: torch.Tensor,
                          nbits: torch.Tensor, offsets: torch.Tensor,
                          num_words: int) -> torch.Tensor:
    """Pack up-to-64-bit items (value = hi << 32 | lo, low `nbits` bits
    significant) into `num_words` u32 words. Offsets must be
    non-decreasing (the JAX sorted path); zero-width items add nothing."""
    nbits = nbits.long()
    lo = lo.long() & low_mask(nbits)
    hi = hi.long() & low_mask(nbits - 32)
    offsets = offsets.long()
    w = offsets >> 5
    sh = offsets & 31
    w0 = shl32(lo, sh)
    w1 = (lo >> (32 - sh)) | shl32(hi, sh)
    w2 = hi >> (32 - sh)
    out = torch.zeros(num_words + 3, dtype=torch.int64, device=lo.device)
    _add_dropping(out, w, w0)
    _add_dropping(out, w + 1, w1)
    _add_dropping(out, w + 2, w2)
    return out[:num_words]


def pack_items96_to_words(w0v: torch.Tensor, w1v: torch.Tensor,
                          w2v: torch.Tensor, nbits: torch.Tensor,
                          offsets: torch.Tensor,
                          num_words: int) -> torch.Tensor:
    """Pack up-to-96-bit items (value = w2v << 64 | w1v << 32 | w0v, low
    `nbits` significant) into `num_words` u32 words. An item spans at most
    four words."""
    nbits = nbits.long()
    w0v = w0v.long() & low_mask(nbits)
    w1v = w1v.long() & low_mask(nbits - 32)
    w2v = w2v.long() & low_mask(nbits - 64)
    offsets = offsets.long()
    w = offsets >> 5
    sh = offsets & 31
    s0 = shl32(w0v, sh)
    s1 = shl32(w1v, sh) | (w0v >> (32 - sh))
    s2 = shl32(w2v, sh) | (w1v >> (32 - sh))
    s3 = w2v >> (32 - sh)
    out = torch.zeros(num_words + 4, dtype=torch.int64, device=w0v.device)
    for k, s in enumerate((s0, s1, s2, s3)):
        _add_dropping(out, w + k, s)
    return out[:num_words]


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host side: u32 LSB-first words -> ceil(total_bits / 8) bytes."""
    nbytes = (int(total_bits) + 7) // 8
    b = np.ascontiguousarray(np.asarray(words).astype("<u4")).view(np.uint8)
    if b.size < nbytes:
        raise ValueError("word buffer too small for total_bits")
    return b[:nbytes].tobytes()


class BitReader:
    """Host-side LSB-first bit reader over a bytes-like object (copy of the
    JAX package's core/bits.py BitReader)."""

    __slots__ = ("data", "pos")  # pos in bits

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos

    def read(self, n: int) -> int:
        """Read n bits LSB-first, advancing the cursor."""
        pos = self.pos
        end = pos + n
        if (end + 7) // 8 > len(self.data):
            raise EOFError("bit stream exhausted")
        byte0 = pos >> 3
        nbytes = ((end + 7) >> 3) - byte0
        chunk = int.from_bytes(self.data[byte0:byte0 + nbytes], "little")
        self.pos = end
        return (chunk >> (pos & 7)) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        """Peek up to n bits without advancing (zero-padded past the end)."""
        pos = self.pos
        byte0 = pos >> 3
        nbytes = ((pos + n + 7) >> 3) - byte0
        chunk = int.from_bytes(self.data[byte0:byte0 + nbytes], "little")
        return (chunk >> (pos & 7)) & ((1 << n) - 1)

    def read_bytes(self, n: int) -> bytes:
        """Read n whole bytes from a byte-aligned cursor."""
        assert self.pos % 8 == 0, "read_bytes requires byte alignment"
        start = self.pos >> 3
        if start + n > len(self.data):
            raise EOFError("byte stream exhausted")
        self.pos += 8 * n
        return self.data[start:start + n]

    def skip(self, n: int) -> None:
        self.pos += n

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7
