"""Checksums (counterpart of deflate_compression_tpu/core/checksum.py, whose
module imports JAX): Adler-32 for the zlib footer (`adler32_np` on the host,
`adler32_torch` on a tensor's device, by the hand kernel of `ops/adler32.py`
on a CUDA card, `adler32_combine`) and CRC-32 for gzip and PNG (`crc32_np`,
`crc32_combine`, `crc32_combine_raw`: host numpy, a copy of the JAX
package's, which has no device CRC either).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.adler32 import adler32 as adler32_kernel
from ..utils.logging_util import spanned

ADLER_MOD = 65521
# largest n with n*(n+1)/2*255 + (n+1)*65520 < 2^32 (zlib's NMAX)
ADLER_NMAX = 5552


def adler32_np(data: np.ndarray, value: int = 1) -> int:
    """Adler-32 of a u8 array, continuing from `value`."""
    data = np.asarray(data, dtype=np.uint8)
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    for start in range(0, data.size, ADLER_NMAX):
        chunk = data[start:start + ADLER_NMAX].astype(np.uint32)
        m = chunk.size
        # b += m*a + sum((m - i) * chunk[i]); a += sum(chunk)
        w = np.arange(m, 0, -1, dtype=np.uint32)
        b = (b + m * a + int(np.dot(w, chunk))) % ADLER_MOD
        a = (a + int(chunk.sum())) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF


def adler32_torch_ref(data: torch.Tensor, valid_len) -> torch.Tensor:
    """Plain version of `adler32_torch` (a port of the JAX package's
    `adler32_jax`): what `adler32_torch` runs for a CPU tensor, and the
    reference its kernel is held against on the card.

    Each NMAX-sized chunk gives its byte sum and its weighted sum
    sum((m - i) * d[i]) in one reduction. The JAX version then folds the
    chunks in a sequential loop mod 65521; the fold is linear, so here it
    is one more reduction: b = sum_c(m_c * a_before_c + wsum_c) with
    a_before_c = 1 + the bytes of the chunks before c (all mod 65521, every
    partial sum well inside int64)."""
    S = data.shape[0]
    dev = data.device
    nch = max(1, -(-S // ADLER_NMAX))
    d = torch.zeros(nch * ADLER_NMAX, dtype=torch.int64, device=dev)
    d[:S] = data.to(torch.int64)
    pos = torch.arange(nch * ADLER_NMAX, device=dev)
    d = torch.where(pos < valid_len, d, 0).view(nch, ADLER_NMAX)
    base = torch.arange(nch, device=dev) * ADLER_NMAX
    m = (torch.as_tensor(valid_len, device=dev) - base).clamp(0, ADLER_NMAX)
    w = torch.arange(ADLER_NMAX, device=dev)
    csum = d.sum(1)
    wsum = ((m.unsqueeze(1) - w) * d).sum(1)
    a_before = (1 + torch.cumsum(csum, 0) - csum) % ADLER_MOD
    b = (m * a_before + wsum).sum() % ADLER_MOD
    a = (1 + csum.sum()) % ADLER_MOD
    return (b << 16) | a


@spanned("checksum.adler32")
def adler32_torch(data: torch.Tensor, valid_len) -> torch.Tensor:
    """Adler-32 of data[:valid_len] (u8[S] tensor) as an int64 0-d tensor
    on data's device. A CUDA tensor goes through the hand kernel
    (`ops/adler32.py`: one launch, no copy from the host, no wait for the
    card; valid_len an int or a one-element tensor on the card) or this
    raises; a CPU tensor through `adler32_torch_ref`.
    `ops.adler32.adler32.launches` counts the kernel's launches."""
    if data.device.type == "cpu":
        return adler32_torch_ref(data, valid_len)
    return adler32_kernel(data, valid_len)


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """Adler of concat(A, B) from adler(A), adler(B), len(B)."""
    a1 = ad1 & 0xFFFF
    b1 = (ad1 >> 16) & 0xFFFF
    a2 = ad2 & 0xFFFF
    b2 = (ad2 >> 16) & 0xFFFF
    rem = len2 % ADLER_MOD
    a = (a1 + a2 - 1) % ADLER_MOD
    b = (b1 + b2 + rem * (a1 - 1)) % ADLER_MOD
    return ((b % ADLER_MOD) << 16) | (a % ADLER_MOD)


# ---------------------------------------------------------------------------
# CRC-32 (reflected, poly 0xEDB88320)
# ---------------------------------------------------------------------------

def _crc_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (np.uint32(0xEDB88320) * (c & np.uint32(1)))
        t[i] = c
    return t


CRC_TABLE = _crc_table()


def _crc32_serial(data: np.ndarray, crc: int) -> int:
    c = np.uint32(crc)
    t = CRC_TABLE
    for byte in data:
        c = t[(c ^ byte) & 0xFF] ^ (c >> np.uint32(8))
    return int(c)


def _gf2_matrix_times(mat: np.ndarray, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= int(mat[i])
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(mat: np.ndarray) -> np.ndarray:
    return np.array([_gf2_matrix_times(mat, int(m)) for m in mat],
                    dtype=np.uint64)


def _one_bit_shift() -> np.ndarray:
    """The GF(2) matrix that shifts a raw CRC register by one zero bit."""
    odd = np.zeros(32, dtype=np.uint64)
    odd[0] = 0xEDB88320
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    return odd


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A, B) from crc(A), crc(B), len(B) (zlib algorithm)."""
    if len2 == 0:
        return crc1
    even = _gf2_matrix_square(_one_bit_shift())
    odd = _gf2_matrix_square(even)
    while True:
        even = _gf2_matrix_square(odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        odd = _gf2_matrix_square(even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def crc32_np(data, crc: int = 0) -> int:
    """CRC-32, numpy lane-parallel: the byte-serial recurrence runs across
    256 lanes at once (one table gather per byte position), then the lane
    CRCs combine with the GF(2) shift matrices."""
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    n = data.size
    crc = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if n < 4096:
        return _crc32_serial(data, crc) ^ 0xFFFFFFFF

    lanes = 256
    chunk = n // lanes
    body = data[:lanes * chunk].reshape(lanes, chunk)
    c = np.zeros(lanes, dtype=np.uint32)
    c[0] = crc          # seed only lane 0; other lanes start at 0
    t = CRC_TABLE
    for j in range(chunk):
        c = t[(c ^ body[:, j]) & 0xFF] ^ (c >> np.uint32(8))
    acc = int(c[0])
    for lane in range(1, lanes):
        # shift acc forward by `chunk` bytes, xor the lane's crc
        acc = crc32_combine_raw(acc, int(c[lane]), chunk)
    acc = _crc32_serial(data[lanes * chunk:], acc)
    return acc ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=64)
def _shift_matrix(len2: int) -> tuple:
    """The matrix (32 ints) that appends len2 zero bytes to a raw CRC
    register, by repeated squaring over the 8 * len2 bits."""
    nbits = 8 * len2
    result = None
    cur = _one_bit_shift()
    while nbits:
        if nbits & 1:
            result = cur if result is None else np.array(
                [_gf2_matrix_times(cur, int(m)) for m in result],
                dtype=np.uint64)
        cur = _gf2_matrix_square(cur)
        nbits >>= 1
    return tuple(int(x) for x in result)


def crc32_combine_raw(crc1_raw: int, crc2_raw: int, len2: int) -> int:
    """Combine raw registers (pre/post-conditioning applied consistently):
    shift crc1 by len2 zero bytes and xor crc2."""
    if len2 == 0:
        return crc1_raw ^ crc2_raw
    mat = np.array(_shift_matrix(len2), dtype=np.uint64)
    return _gf2_matrix_times(mat, crc1_raw) ^ crc2_raw
