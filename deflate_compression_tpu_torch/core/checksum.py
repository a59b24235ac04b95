"""Checksums (counterpart of deflate_compression_tpu/core/checksum.py, whose
module imports JAX): Adler-32 for the zlib footer (`adler32_np` on the host,
`adler32_torch` on a tensor's device, by the hand kernel of `ops/adler32.py`
on a CUDA card, `adler32_combine`) and CRC-32 for gzip and PNG (`crc32_np`,
`crc32_combine`, `crc32_combine_raw` on the host, with the JAX package's
results; `crc32_torch` on a tensor's device, by the hand kernel of
`ops/crc32.py` on a CUDA card, which the JAX package has no counterpart of).
The host combines multiply by x^(8n) mod p(x) as zlib does (`x8nmodp`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.adler32 import adler32 as adler32_kernel
from ..ops.crc32 import crc32 as crc32_kernel
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

CRC_POLY = 0xEDB88320


def _crc_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (np.uint32(CRC_POLY) * (c & np.uint32(1)))
        t[i] = c
    return t


CRC_TABLE = _crc_table()


def _crc32_serial(data: np.ndarray, crc: int) -> int:
    c = np.uint32(crc)
    t = CRC_TABLE
    for byte in data:
        c = t[(c ^ byte) & 0xFF] ^ (c >> np.uint32(8))
    return int(c)


def multmodp(a: int, b: int) -> int:
    """a(x) b(x) mod p(x) for two reflected CRC-32 polynomials (bit 31 is
    x^0, bit 0 x^31): zlib's multmodp, one step a bit of `a`."""
    p = 0
    for i in range(31, -1, -1):
        if a >> i & 1:
            p ^= b
        b = (b >> 1) ^ CRC_POLY if b & 1 else b >> 1
    return p


def _x2n_table() -> tuple:
    """x^(2^k) mod p(x), reflected, k = 0..63."""
    t = [1 << 30]                                 # x^1
    for _ in range(63):
        t.append(multmodp(t[-1], t[-1]))
    return tuple(t)


X2N = _x2n_table()


@functools.lru_cache(maxsize=256)
def x8nmodp(n: int) -> int:
    """x^(8n) mod p(x), reflected: what appending n zero bytes multiplies a
    raw CRC register by (zlib's x2nmodp(n, 3))."""
    p, k = 1 << 31, 3                             # x^0
    while n:
        if n & 1:
            p = multmodp(X2N[k], p)
        n >>= 1
        k += 1
    return p


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A, B) from crc(A), crc(B), len(B): crc(A) times
    x^(8 len(B)) mod p(x), xor crc(B) (zlib's crc32_combine)."""
    if len2 == 0:
        return crc1
    return (multmodp(x8nmodp(len2), crc1) ^ crc2) & 0xFFFFFFFF


def crc32_np(data, crc: int = 0) -> int:
    """CRC-32, numpy lane-parallel: the byte-serial recurrence runs across
    256 lanes at once (one table gather per byte position), then the lane
    CRCs combine, each shifted by the lanes after it (x^(8 chunk) mod
    p(x))."""
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
    op = x8nmodp(chunk)
    for lane in range(1, lanes):
        # shift acc forward by `chunk` bytes, xor the lane's crc
        acc = multmodp(op, acc) ^ int(c[lane])
    acc = _crc32_serial(data[lanes * chunk:], acc)
    return acc ^ 0xFFFFFFFF


def crc32_combine_raw(crc1_raw: int, crc2_raw: int, len2: int) -> int:
    """Combine raw registers (pre/post-conditioning applied consistently):
    shift crc1 by len2 zero bytes and xor crc2."""
    return multmodp(x8nmodp(len2), crc1_raw) ^ crc2_raw


# lanes of crc32_torch_ref: at most this many bytes a lane
_REF_STEPS = 2048


def _mulmod_t(a: torch.Tensor, b: int) -> torch.Tensor:
    """multmodp of each element of `a` (int64 holding u32) by `b`."""
    p = torch.zeros_like(a)
    for i in range(31, -1, -1):
        if b >> i & 1:
            p ^= a
        a = (a >> 1) ^ torch.where(a & 1 == 1, CRC_POLY, 0)
    return p


def crc32_torch_ref(data: torch.Tensor, valid_len, init=None) -> torch.Tensor:
    """Plain version of `crc32_torch`: what it runs for a CPU tensor, and
    the reference its kernel is held against on the card.

    The raw register (crc ^ 0xFFFFFFFF) is linear in the bytes, and feeding
    it in is the same as xoring it into the first four: so ~init goes into
    data[:4] (what stays of it when there are fewer bytes is shifted out at
    the end), the bytes are cut into a power-of-two number of equal lanes
    (zeros in front, which leave a register at 0 unchanged), each lane runs
    zlib's byte table recurrence, all lanes at once, and pairs of
    neighbouring lanes merge, the left one multiplied by x^(8 w) mod p(x)
    for the right one's w bytes, until one is left."""
    n = int(valid_len)
    if not 0 <= n <= data.shape[0]:
        raise ValueError(f"valid_len {n} outside [0, {data.shape[0]}]")
    r0 = (int(0 if init is None else init) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    lanes = 1 << max(0, -(-n // _REF_STEPS) - 1).bit_length()
    w = max(1, -(-n // lanes))
    d = torch.zeros(lanes * w, dtype=torch.int64, device=data.device)
    d[lanes * w - n:] = data[:n].to(torch.int64)
    k = min(n, 4)
    d[lanes * w - n:lanes * w - n + k] ^= torch.tensor(
        [(r0 >> (8 * j)) & 0xFF for j in range(k)], dtype=torch.int64,
        device=data.device)
    rows = d.view(lanes, w)
    table = torch.from_numpy(CRC_TABLE.astype(np.int64)).to(data.device)
    r = torch.zeros(lanes, dtype=torch.int64, device=data.device)
    for j in range(w):
        r = table[(r ^ rows[:, j]) & 0xFF] ^ (r >> 8)
    while r.shape[0] > 1:
        r = _mulmod_t(r[0::2], x8nmodp(w)) ^ r[1::2]
        w *= 2
    total = int(r[0]) ^ (r0 >> (8 * n) if n < 4 else 0)
    return torch.tensor(total ^ 0xFFFFFFFF, dtype=torch.int64,
                        device=data.device)


@spanned("checksum.crc32")
def crc32_torch(data: torch.Tensor, valid_len, init=None) -> torch.Tensor:
    """CRC-32 of data[:valid_len] (u8[S] tensor), continued from `init` (0
    where None: an int, or a one-element integer tensor on data's device),
    as an int64 0-d tensor on data's device: zlib.crc32(data[:valid_len],
    init). A CUDA tensor goes through the hand kernel (`ops/crc32.py`: one
    launch, no copy from the host, no wait for the card; valid_len and init
    may be held on the card) or this raises; a CPU tensor through
    `crc32_torch_ref`. `ops.crc32.crc32.launches` counts the kernel's
    launches."""
    if data.device.type == "cpu":
        return crc32_torch_ref(data, valid_len, init)
    return crc32_kernel(data, valid_len, 0 if init is None else init)
