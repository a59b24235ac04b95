"""CRC-32 in the port: `crc32_torch` (its plain version on the CPU, the hand
kernel of csrc/crc32.cu on a card), the host combines, and a numpy model
of the kernel.

The CUDA kernel cannot run here, so a numpy model of its arithmetic is held
against zlib.crc32 exactly: the array placed `head` bytes past a 16-byte
boundary with other bytes around it; `ops/crc32.grid`'s back-aligned span
(zeros in front); each vector cut from two aligned vectors at the launch's
byte offset, masked in front and the starting register xored into data
bytes 0-3; each thread's run by slice-by-8 tables built from the
polynomial as each CTA builds them; its result times `pow_table`'s power
for the runs after it, the CTA's xor, the last CTA's powers for the
segments after each. Also the power table, the grid, the wrapper's checks
(which raise before anything is built: here a build would fail, with no
nvcc) and, on a card, the kernel itself (these skip without one). This file
imports no JAX, so on a machine with a card and no JAX it runs as
    python -m pytest tests/test_torch_crc32.py --noconftest -q
"""
import zlib

import numpy as np
import pytest
import torch

from deflate_compression_tpu_torch.core import checksum as CK
from deflate_compression_tpu_torch.ops import crc32 as CR

MIB = 1 << 20
LENGTHS = [0, 1, 3, 4, 4095, 4096, 4097, 65_543, MIB + 3]
H100_CTAS = min(CR.MAX_CTAS, CR.CTAS_PER_SM * 132)    # 132 SMs


def data_of(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def slice_tables() -> np.ndarray:
    """The kernel's eight tables: t[0] zlib's, t[k][i] = R(0, i then k
    zero bytes), each from the one before and t[0]."""
    t = np.zeros((8, 256), np.uint32)
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = (c >> 1) ^ np.where(c & 1, np.uint32(CR.POLY), np.uint32(0))
    t[0] = c
    for k in range(1, 8):
        c = (c >> 8) ^ t[0][c & 0xFF]
        t[k] = c
    return t


T8 = slice_tables()


def step8(r, w0, w1):
    x = r ^ w0
    return (T8[7][x & 255] ^ T8[6][(x >> 8) & 255] ^ T8[5][(x >> 16) & 255]
            ^ T8[4][x >> 24] ^ T8[3][w1 & 255] ^ T8[2][(w1 >> 8) & 255]
            ^ T8[1][(w1 >> 16) & 255] ^ T8[0][w1 >> 24])


def kernel_model(data: np.ndarray, n: int, head: int = 0, init: int = 0,
                 n_on_card: bool = False, target: int = H100_CTAS) -> int:
    """What csrc/crc32.cu computes for data[:n] at an address `head` bytes
    past a 16-byte boundary (the grid from len(data) where the kernel reads
    n on the card). The bytes around the array are 0xA5, as the kernel may
    read them."""
    size = data.size
    a, ctas = CR.grid(size if n_on_card else n, target)
    vec, nthr = 1 << a, ctas * CR.THREADS
    total = nthr * vec
    mem = np.full(((head + size) // 16 + 1) * 16, 0xA5, np.uint8)
    mem[head:head + size] = data
    e = head + n
    off = e & 15
    gmax = (e - 1) // 16 if n > 0 else -1
    aligned = mem[:16 * (gmax + 1)].reshape(-1, 16)

    def fetch(g):                     # only vectors holding a data byte
        ok = (g >= 0) & (g <= gmax)
        out = np.zeros((g.size, 16), np.uint8)
        out[ok] = aligned[g[ok]]
        return out
    q = n - 16 * (total - np.arange(total, dtype=np.int64))   # data index
    g = (q + head - off) // 16
    assert ((q + head - off) % 16 == 0).all()
    v = np.concatenate([fetch(g), fetch(g + 1)], 1)[:, off:off + 16].copy()
    r0 = ~init & 0xFFFFFFFF
    i = q[:, None] + np.arange(16)
    v[i < 0] = 0
    fr = (i >= 0) & (i < 4)
    v[fr] ^= np.array([(r0 >> (8 * k)) & 0xFF for k in range(4)],
                      np.uint8)[i[fr]]
    words = v.view("<u4").reshape(nthr, vec, 4)
    r = np.zeros(nthr, np.uint32)
    for j in range(vec):
        r = step8(r, words[:, j, 0], words[:, j, 1])
        r = step8(r, words[:, j, 2], words[:, j, 3])
    pw = CR.pow_table()
    t = np.arange(nthr) % CR.THREADS
    r = CR._mulmod(r, pw[a + 7][CR.THREADS - 1 - t]).astype(np.uint32)
    seg = np.bitwise_xor.reduce(r.reshape(ctas, CR.THREADS), axis=1)
    c = np.arange(ctas)
    seg = CR._mulmod(seg, pw[a + 15][ctas - 1 - c]).astype(np.uint32)
    out = int(np.bitwise_xor.reduce(seg))
    if n < 4:
        out ^= r0 >> (8 * n)
    return out ^ 0xFFFFFFFF


# ------------------------------------------------------------ plain version

@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_torch_ref_matches_zlib(n):
    data = data_of(n + 7, seed=n)
    x = torch.from_numpy(data)
    for init in (0, 0xDEADBEEF, 0xFFFFFFFF):
        want = zlib.crc32(data[:n].tobytes(), init)
        got = CK.crc32_torch_ref(x, n, init)
        assert (got.dtype, got.dim()) == (torch.int64, 0)
        assert int(got) == want, (n, init)
        assert int(CK.crc32_torch_ref(x, torch.tensor(n),
                                      torch.tensor(init))) == want
    assert int(CK.crc32_torch_ref(x, n)) == zlib.crc32(data[:n].tobytes())


def test_crc32_torch_takes_the_plain_version_on_cpu():
    data = data_of(70_001)
    x = torch.from_numpy(data)
    before = CR.crc32.launches
    got = CK.crc32_torch(x, torch.tensor(69_999), init=7)
    assert int(got) == zlib.crc32(data[:69_999].tobytes(), 7)
    assert got.device.type == "cpu" and CR.crc32.launches == before
    with pytest.raises(ValueError):
        CK.crc32_torch(x, 70_002)


@pytest.mark.parametrize("cuts", [[1, 2], [3, 4093, 4097], [65_543, 7],
                                  [0, 5, 0, MIB + 3, 11]])
def test_init_chains_over_uneven_splits(cuts):
    data = data_of(sum(cuts), seed=len(cuts))
    x = torch.from_numpy(data)
    crc, at = None, 0
    for c in cuts:
        crc = CK.crc32_torch(x[at:at + c], c, init=crc)
        at += c
    assert int(crc) == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("n1", [0, 1, 7, 4096])
@pytest.mark.parametrize("n2", [0, 1, 3, 4095, 4097, 65_543, MIB + 3])
def test_combines_match_zlib(n1, n2):
    a, b = data_of(n1, 1).tobytes(), data_of(n2, 2).tobytes()
    ca, cb = zlib.crc32(a), zlib.crc32(b)
    assert CK.crc32_combine(ca, cb, n2) == zlib.crc32(a + b)
    # raw registers: A's from all ones (the CRC's start), B's from 0,
    # B's shifted in after A's
    raw_a = ca ^ 0xFFFFFFFF
    raw_b = zlib.crc32(b, 0xFFFFFFFF) ^ 0xFFFFFFFF
    assert CK.crc32_combine_raw(raw_a, raw_b, n2) == \
        zlib.crc32(a + b) ^ 0xFFFFFFFF


def test_x8nmodp_is_appending_zero_bytes():
    rng = np.random.default_rng(3)
    for n in (0, 1, 5, 4096, 65_543):
        r = int(rng.integers(0, 2 ** 32))
        want = CK._crc32_serial(np.zeros(n, np.uint8), r)
        assert CK.multmodp(CK.x8nmodp(n), r) == want


def test_pow_table_holds_the_powers():
    pw = CR.pow_table()
    assert pw.shape == (CR.POW_ROWS, 256) and pw.dtype == np.uint32
    rng = np.random.default_rng(5)
    for m in range(CR.POW_ROWS):
        for k in [0, 1, 2, 255, *rng.integers(0, 256, 3)]:
            p = 1 << 31                     # x^0, times x^(2^m) k times
            for _ in range(int(k)):
                p = CK.multmodp(CK.X2N[m], p)
            assert int(pw[m, k]) == p, (m, k)


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("size,n", [(0, 0), (1, 1), (3, 3), (4, 4), (5, 5),
                                    (17, 17), (100, 50), (4095, 4095),
                                    (4097, 4097), (65_543, 65_543),
                                    (65_543, 1000), (MIB + 3, MIB + 3),
                                    (4 * MIB, 4 * MIB)])
def test_kernel_model_matches_zlib(size, n):
    data = data_of(size, seed=size)
    for head in (0, 3, 9, 15):
        for init in (0, 0xDEADBEEF):
            want = zlib.crc32(data[:n].tobytes(), init)
            assert kernel_model(data, n, head, init) == want, (head, init)
    if size <= 65_543:
        for head in (0, 7):
            assert kernel_model(data, n, head, 5, n_on_card=True) == \
                zlib.crc32(data[:n].tobytes(), 5)


def test_kernel_model_on_a_one_cta_grid():
    """A small target: fewer, longer runs (a > 0) in one CTA."""
    data = data_of(200_003, seed=9)
    for n in (200_003, 123_457):
        assert kernel_model(data, n, 11, 99, target=1) == \
            zlib.crc32(data[:n].tobytes(), 99)


@pytest.mark.parametrize("bound", [0, 1, 16, 4096 * 16 + 1, MIB, 4 * MIB,
                                   64 * MIB + 5])
@pytest.mark.parametrize("target", [1, 7, H100_CTAS])
def test_grid_covers_and_fills(bound, target):
    if bound > target * CR.THREADS * (CR.VEC_BYTES << CR.MAX_LOG2_VEC):
        with pytest.raises(ValueError):
            CR.grid(bound, target)
        return
    a, ctas = CR.grid(bound, target)
    span = ctas * CR.THREADS * (CR.VEC_BYTES << a)
    assert span >= bound and 1 <= ctas <= target
    assert 0 <= a <= CR.MAX_LOG2_VEC and a + 15 < CR.POW_ROWS
    if a:                             # the smallest runs that fit
        assert -(-max(1, -(-bound // 16)) // (CR.THREADS << (a - 1))) \
            > target


def test_grid_refuses_what_the_table_cannot_shift():
    with pytest.raises(ValueError):
        CR.grid(CR.MAX_CTAS * CR.THREADS * (16 << CR.MAX_LOG2_VEC) + 1,
                CR.MAX_CTAS)


@pytest.mark.parametrize("data,valid_len,init,err", [
    (torch.zeros(8, dtype=torch.int32), 8, 0, TypeError),
    (torch.zeros(2, 8, dtype=torch.uint8), 8, 0, ValueError),
    (torch.zeros(16, dtype=torch.uint8)[::2], 8, 0, ValueError),
    (torch.zeros(8, dtype=torch.uint8), 9, 0, ValueError),
    (torch.zeros(8, dtype=torch.uint8), -1, 0, ValueError),
    (torch.zeros(8, dtype=torch.uint8), 8, 0, ValueError),   # not on a card
    (torch.zeros(8, dtype=torch.uint8), 8, 1.5, TypeError),
])
def test_kernel_wrapper_refuses_before_building(data, valid_len, init, err,
                                                monkeypatch):
    def no_build():
        raise AssertionError("the wrapper built before checking")
    monkeypatch.setattr(CR, "_bind", no_build)
    with pytest.raises(err):
        CR.crc32(data, valid_len, init)


# ------------------------------------------------------------- on a card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the kernel is verified by "
                    "chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS + [4 * MIB, 4 * MIB + 1])
def test_crc32_kernel_matches_zlib(cuda, n):
    data = data_of(n + 64, seed=n)
    x = torch.from_numpy(data).to(cuda)
    for offset in (0, 1, 7, 15):
        for init in (0, 0xDEADBEEF):
            want = zlib.crc32(data[offset:offset + n].tobytes(), init)
            before = CR.crc32.launches
            got = CK.crc32_torch(x[offset:], n, init=init)
            assert CR.crc32.launches == before + 1
            assert (got.device, got.dtype, got.dim()) == \
                (x.device, torch.int64, 0)
            assert int(got) == want, (offset, init)
            got = CK.crc32_torch(x[offset:], torch.tensor(n, device=cuda),
                                 init=torch.tensor(init, device=cuda))
            assert int(got) == want, (offset, init, "on the card")
    assert int(CK.crc32_torch_ref(x.cpu(), n)) == zlib.crc32(
        data[:n].tobytes())


@pytest.mark.cuda
def test_crc32_kernel_chains_on_the_card(cuda):
    data = data_of(9 * MIB + 5, seed=3)
    x = torch.from_numpy(data).to(cuda)
    crc, at = None, 0
    for c in (4 * MIB, 1, 3, 4 * MIB - 7, MIB + 8):
        crc = CK.crc32_torch(x[at:at + c], c, init=crc)
        at += c
    assert int(crc) == zlib.crc32(data.tobytes())
    # a length on the card is clamped to [0, len(data)]
    assert int(CK.crc32_torch(x[:100], torch.tensor(10 ** 9, device=cuda))) \
        == zlib.crc32(data[:100].tobytes())
    assert int(CK.crc32_torch(x, torch.tensor(-5, device=cuda), 77)) == 77


@pytest.mark.cuda
def test_crc32_kernel_queues_without_waiting(cuda):
    """Calls with lengths and starting values as ints and on the card queue
    behind a spin kernel: the host returns while the spin still runs, under
    sync debug mode "error", and the results are right once it ends."""
    data = data_of(4 * MIB, seed=4)
    x = torch.from_numpy(data).to(cuda)
    n_card = torch.tensor(4 * MIB - 3, device=cuda)
    CK.crc32_torch(x, 5)                      # build, bind, the power table
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(200_000_000)        # about 0.1 s
        a = CK.crc32_torch(x, 4 * MIB)
        b = CK.crc32_torch(x, n_card, init=a)
        done = torch.cuda.Event()
        done.record()
        assert not done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    whole = zlib.crc32(data.tobytes())
    assert [int(a), int(b)] == [whole,
                                zlib.crc32(data[:-3].tobytes(), whole)]


@pytest.mark.cuda
def test_crc32_kernel_one_launch_no_copy(cuda):
    """Under the profiler a call is one kernel on the card: no copy from
    the host, no memset."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.from_numpy(data_of(4 * MIB)).to(cuda)
    init = CK.crc32_torch(x, 4 * MIB)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        CK.crc32_torch(x, 4 * MIB, init=init)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("crc32_kernel" in n for n in names) == 1, names
    assert not any("Memcpy" in n or "Memset" in n for n in names), names
