"""Adler-32 (counterpart of deflate_compression_tpu/core/checksum.py, whose
module imports JAX): `adler32_np` on the host, `adler32_torch` on a tensor's
device, and `adler32_combine`."""
from __future__ import annotations

import numpy as np
import torch

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


def adler32_torch(data: torch.Tensor, valid_len) -> torch.Tensor:
    """Adler-32 of data[:valid_len] (u8[S] tensor) as an int64 0-d tensor
    on data's device; port of the JAX package's `adler32_jax`.

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
