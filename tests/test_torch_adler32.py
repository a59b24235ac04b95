"""The Adler-32 kernel (csrc/adler32.cu, ops/adler32.py) on the CPU.

The CUDA kernel cannot run here, so a numpy model of its arithmetic is held
against zlib.adler32 and the plain version, `adler32_torch_ref`, exactly:
the array placed `head` bytes past a 16-byte boundary with other bytes
around it; the aligned span cut into `ops/adler32.grid`'s segments of
THREADS x vec vectors of 16 bytes; each vector's byte sum and sum k * x[k]
with the kernel's __dp4a weight words, the head and tail vectors masked;
each thread's sums, each CTA's exact (A_c, J_c) in 64 bits and its partial
((n - s_c) A_c - J_c mod p, A_c mod p); the last CTA's sum of the
partials. Also the linear fold the kernel's note rests on, the grid's
sizes, and the wrapper's checks, which raise before anything is built
(here a build would fail otherwise, with no nvcc).
This file imports no JAX: tests/test_torch_cuda.py takes its cases.
"""
import zlib

import numpy as np
import pytest
import torch

from deflate_compression_tpu_torch.core import checksum as CK
from deflate_compression_tpu_torch.ops import adler32 as AD

P = 65521
MIB = 1 << 20
# the kernel's weight words for sum k * x[k] over a vector's 16 bytes, and
# the byte sum's: byte b of a little-endian word is its bits 8b..8b+7
WEIGHT_WORDS = (0x03020100, 0x07060504, 0x0B0A0908, 0x0F0E0D0C)
ONES = 0x01010101
H100_CTAS = AD.CTAS_PER_SM * 132        # the H100 SXM's 132 SMs


def dp4a_weights(words) -> np.ndarray:
    return np.array(words, "<u4").view(np.uint8).astype(np.int64)


def kernel_model(data: np.ndarray, n: int, head: int = 0,
                 n_on_card: bool = False, target: int = H100_CTAS) -> int:
    """What csrc/adler32.cu computes for data[:n] at an address `head`
    bytes past a 16-byte boundary (the grid from len(data) where the kernel
    reads n on the card). The bytes around the array are 0xA5, as the
    kernel may read them."""
    size = data.size
    vec, ctas = AD.grid(size if n_on_card else n, head, target)
    seg = AD.THREADS * vec * AD.VEC_BYTES
    mem = np.full(max(ctas * seg, head + size + 16), 0xA5, np.uint8)
    mem[head:head + size] = data
    mem = mem[:ctas * seg]                          # the segments' span
    i = np.arange(ctas * seg, dtype=np.int64) - head       # byte index
    nvec = (n + head + 15) // 16
    g = np.arange(ctas * seg // 16, dtype=np.int64)
    read = np.repeat(g < nvec, 16)                  # vectors the kernel loads
    x = np.where(read & (i >= 0) & (i < n), mem, 0).astype(np.int64)
    x = x.reshape(ctas, vec, AD.THREADS, 16)
    s = x @ dp4a_weights((ONES,) * 4)               # (ctas, vec, THREADS)
    k = x @ dp4a_weights(WEIGHT_WORDS)
    o = (np.arange(vec)[:, None] * AD.THREADS
         + np.arange(AD.THREADS)[None, :]) * 16     # the vector in its segment
    a_t = s.sum(1)                                  # each thread's sums
    j_t = (o * s + k).sum(1)
    assert a_t.max() < 2 ** 32 and j_t.max() < 2 ** 63
    A = a_t.sum(1)                                  # each CTA's, exact
    J = j_t.sum(1)
    assert A.max() < 2 ** 32 and J.max() < 2 ** 63
    s0 = np.arange(ctas, dtype=np.int64) * seg - head
    nm = (n - s0) % P
    t = (nm * (A % P) + P - J % P) % P              # each CTA's partial
    assert (nm * (A % P) + P).max() < 2 ** 63
    a = (1 + int((A % P).sum())) % P
    b = (n % P + int(t.sum())) % P
    return (b << 16) | a


def chunk_fold(data: np.ndarray, n: int, L: int) -> int:
    """The plain version's fold over chunks of L bytes,
    b = sum_c (L_c a_before_c + w_c), beside its expanded form
    b = n + sum_c (w_c + (n - e_c) A_c), which the kernel adds up."""
    d = data[:n].astype(np.int64)
    a_before, b, b_expanded, A_all = 1, 0, n, 0
    for start in range(0, n, L):
        c = d[start:start + L]
        m = c.size
        A = int(c.sum())
        w = int((np.arange(m, 0, -1) * c).sum())
        b += m * a_before + w
        b_expanded += w + (n - start - m) * A
        a_before += A
        A_all += A
    assert b % P == b_expanded % P
    return ((b % P) << 16) | ((1 + A_all) % P)


def case_data(kind: str, size: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + size)
    if kind == "ff":
        return np.full(size, 0xFF, np.uint8)
    if kind == "zero":
        return np.zeros(size, np.uint8)
    return rng.integers(0, 256, size, dtype=np.uint8)


# (kind, tensor bytes, valid_len): 0 and 1; zlib's NMAX 5,552 +- 1; a
# segment boundary +- 1 at 1 MiB (4 KiB segments) and at 4 MiB (16 KiB);
# valid_len below the tensor's length with nonzero bytes past it; all 0xFF
# at 4 MiB (the largest sums); 4 MiB + 1
CASES = [
    ("random", 64, 0), ("random", 64, 1), ("random", 1, 1), ("random", 0, 0),
    ("random", 6000, 5551), ("random", 6000, 5552), ("random", 6000, 5553),
    ("random", MIB, MIB - 1), ("random", MIB + 1, MIB + 1),
    ("random", 24_000, 5 * 4096 - 1), ("random", 24_000, 5 * 4096 + 1),
    ("random", 4 * MIB + 16, 3 * 16384 - 1),
    ("random", 4 * MIB, 4 * MIB - 1), ("random", 4 * MIB, 4 * MIB),
    ("random", 100_000, 33_333), ("ff", 100_000, 70_001),
    ("ff", 4 * MIB, 4 * MIB), ("random", 4 * MIB + 1, 4 * MIB + 1),
    ("zero", 4096, 4096),
]
CASE_IDS = [f"{k}-{s}-{n}" for k, s, n in CASES]


@pytest.mark.parametrize("kind,size,n", CASES, ids=CASE_IDS)
def test_kernel_model_matches_zlib_and_plain(kind, size, n):
    data = case_data(kind, size)
    want = zlib.adler32(data[:n].tobytes())
    assert int(CK.adler32_torch_ref(torch.from_numpy(data), n)) == want
    assert int(CK.adler32_torch(torch.from_numpy(data), n)) == want
    for head in (0, 1, 15):
        assert kernel_model(data, n, head) == want, head
    assert kernel_model(data, n, 3, target=AD.CTAS_PER_SM * 78) == want
    if n < size:                        # the grid from the tensor's length
        assert kernel_model(data, n, 7, n_on_card=True) == want


@pytest.mark.parametrize("L", [1, 5552, 16384])
def test_linear_fold_matches_zlib(L):
    data = case_data("random", 50_000, seed=L)
    for n in (0, 1, 5553, 50_000):
        assert chunk_fold(data, n, L) == zlib.adler32(data[:n].tobytes())


@pytest.mark.parametrize("bound", [0, 1, 5552, MIB - 1, MIB, 4 * MIB,
                                   4 * MIB + 1, 64 * MIB, 3 << 30])
@pytest.mark.parametrize("head", [0, 1, 15])
@pytest.mark.parametrize("target", [H100_CTAS, AD.CTAS_PER_SM * 78])
def test_grid_covers_and_fills(bound, head, target):
    vec, ctas = AD.grid(bound, head, target)
    seg = AD.THREADS * vec * AD.VEC_BYTES
    assert 1 <= vec <= AD.MAX_VEC and ctas >= 1
    assert ctas * seg >= bound + head            # every byte in a segment
    assert (ctas - 1) * seg < max(bound + head, 1)   # no empty segment
    if MIB <= bound <= 64 * MIB:        # a 1 MiB group and a 4 MiB shard
        assert ctas <= target and (ctas > target // 2 or vec == 1)
        if target == H100_CTAS:
            assert target - 10 <= ctas <= target + 10 \
                or vec == 1 and ctas >= 256
    if bound == 3 << 30:                # segments stop at 1 MiB
        assert vec == AD.MAX_VEC and seg == MIB


def test_adler32_torch_takes_the_plain_version_on_cpu():
    data = torch.from_numpy(case_data("random", 70_000))
    before = AD.adler32.launches
    got = CK.adler32_torch(data, 65_536)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == zlib.adler32(data[:65_536].numpy().tobytes())
    assert int(CK.adler32_torch(data, torch.tensor(65_536))) == int(got)
    assert AD.adler32.launches == before


@pytest.mark.parametrize("data,valid_len,err", [
    (torch.zeros(8, dtype=torch.int32), 8, TypeError),
    ([0] * 8, 8, TypeError),
    (torch.zeros(2, 8, dtype=torch.uint8), 8, ValueError),
    (torch.zeros(16, dtype=torch.uint8)[::2], 8, ValueError),
    (torch.zeros(8, dtype=torch.uint8), 9, ValueError),
    (torch.zeros(8, dtype=torch.uint8), -1, ValueError),
    (torch.zeros(8, dtype=torch.uint8), 2.5, TypeError),
    (torch.zeros(8, dtype=torch.uint8), 8, ValueError),   # not on a card
], ids=["int32", "list", "2d", "strided", "long", "negative", "float",
        "cpu"])
def test_kernel_wrapper_refuses_before_building(data, valid_len, err):
    with pytest.raises(err):
        AD.adler32(data, valid_len)
