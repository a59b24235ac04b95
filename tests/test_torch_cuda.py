"""Tests of the port that need a CUDA card; each skips where there is none.

This file imports no JAX, so on a machine with a card and no JAX it runs
without the repository's conftest (which imports JAX) as
    python -m pytest tests/test_torch_cuda.py --noconftest -q
A skipped kernel test counts as unverified; chip_smoke.py verifies the
kernel on the card as well.
"""
import zlib

import numpy as np
import pytest
import torch

from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.decode import device_inflate as DI
from deflate_compression_tpu_torch.decode import index as tidx
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.ops import decode_symbols as DS
from deflate_compression_tpu_torch.ops import histogram as H
from deflate_compression_tpu_torch.ops import lut_gather as LG
from test_torch_lanes import lanes_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the kernel is verified by chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,nc", [(32, 286), (32, 30), (17, 286), (1, 286)])
def test_tile_histogram_kernel_matches_plain(cuda, rows, nc):
    rng = np.random.default_rng(rows)
    sym = torch.from_numpy(rng.integers(-1, nc + 4, (rows, 32768))
                           .astype(np.int32)).to(cuda)
    before = H.tile_histogram.launches
    got = H.tile_histogram(sym, nc)
    torch.cuda.synchronize()
    assert H.tile_histogram.launches == before + 1
    assert torch.equal(got, H.tile_histogram_ref(sym, nc))


def _hist_rows(rows, length, nc, dtype, seed, offset=0):
    """Symbols in [-3, nc + 3) on the card; row 0 holds one symbol only and
    row 1 (if any) only symbols outside [0, nc). With an offset the rows
    start that many elements into their buffer, off 16-byte alignment."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(-3, nc + 3, rows * length + offset)
    v = sym[offset:].reshape(rows, length)
    v[0] = nc // 2
    if rows > 1:
        v[1] = rng.choice([-1, nc, nc + 7, -2**31], length)
    t = torch.from_numpy(sym).to(dtype)
    return t.cuda()[offset:].view(rows, length)


def _same_hist(sym, nc):
    before = H.tile_histogram.launches
    got = H.tile_histogram(sym, nc)
    torch.cuda.synchronize()
    assert H.tile_histogram.launches == before + 1
    assert got.dtype == sym.dtype and got.shape == (sym.shape[0], nc)
    assert torch.equal(got, H.tile_histogram_ref(sym, nc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows", [1, 17, 32, 64])
@pytest.mark.parametrize("nc", [1, 30, 286, H.MAX_CLASSES])
def test_tile_histogram_kernel_types_rows_classes(cuda, dtype, rows, nc):
    _same_hist(_hist_rows(rows, 32768, nc, dtype, rows * nc), nc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("length,offset", [(32771, 0), (32771, 1),
                                           (4099, 3), (1, 0), (7, 2)])
def test_tile_histogram_kernel_unaligned_rows(cuda, dtype, length, offset):
    """Row lengths off a multiple of the vector width, and rows that start
    off a 16-byte boundary: the kernel's scalar head and tail."""
    _same_hist(_hist_rows(5, length, 286, dtype, length, offset), 286)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length", [(300, 32768), (32, 4096),
                                         (128, 32768), (32, 8192),
                                         (64, 32768), (32, 16384)])
def test_tile_histogram_kernel_cluster_sizes(cuda, rows, length):
    """Shapes for which the launcher splits a row over 1, 2 and 4 CTAs
    (32 full rows take 8), on the encoder's int64 symbols and int32, with
    a row of one symbol."""
    sym = _hist_rows(rows, length, 286, torch.int64, rows + length)
    sym[2] = 285
    _same_hist(sym, 286)
    _same_hist(sym.int(), 30)


@pytest.mark.cuda
@pytest.mark.parametrize("size,valid_len,final", [
    (65536, 65536, True), (1 << 20, 700001, False),
    (4 << 20, (4 << 20) - 12345, False), (1_081_344, 1_081_344, True)])
def test_encode_shard_cuda_matches_cpu(cuda, size, valid_len, final):
    x = torch.from_numpy(corpus.sample("mixed", size, seed=1))
    before = H.tile_histogram.launches
    g = td.encode_shard(x.to(cuda), valid_len, final)
    assert H.tile_histogram.launches == before + 2
    c = td.encode_shard(x, valid_len, final)
    nw = (int(c["total_bits"]) + 31) // 32
    assert torch.equal(g["words"][:nw].cpu(), c["words"][:nw])
    for k in c:
        if k != "words":
            assert torch.equal(g[k].cpu(), c[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [128, 256])
@pytest.mark.parametrize("nc", [286, 30])
def test_tile_histogram_kernel_large_shard_rows(cuda, rows, nc):
    """The rows of one 4 MB (128 tiles) and one 8 MB shard, on the
    encoder's int64 symbols and on int32."""
    sym = _hist_rows(rows, 32768, nc, torch.int64, rows + nc)
    _same_hist(sym, nc)
    _same_hist(sym.int(), nc)


@pytest.mark.cuda
def test_self_check_on_the_card(cuda):
    from deflate_compression_tpu_torch.models import codec as tcodec
    from deflate_compression_tpu_torch.utils.config import CodecConfig
    raw = corpus.build_corpus(3 * 65536 + 999, seed=12)
    cfg = CodecConfig(shard_size=65536, container="gzip", self_check=True)
    blob = tcodec.GzipCodec(cfg, device="cuda").compress(raw)
    assert blob == tcodec.GzipCodec(cfg, device="cpu").compress(raw)
    assert tcodec.GzipCodec(cfg, device="cuda").decompress(blob) == raw


@pytest.mark.cuda
def test_trace_on_the_card_matches_cpu(cuda):
    from deflate_compression_tpu_torch.utils.trace import per_symbol_trace_csv
    raw = corpus.sample("mixed", 40_000, seed=3).tobytes()
    kw = {"stride": 13, "header_stride": 5}
    before = H.tile_histogram.launches
    got = per_symbol_trace_csv(raw, device="cuda", **kw)
    assert H.tile_histogram.launches == before       # tokenize only
    assert got == per_symbol_trace_csv(raw, device="cpu", **kw)


@pytest.mark.cuda
def test_flat_decode_of_4mb_shards(cuda):
    """Two 4 MB shards (the second short) encoded on the card and decoded
    in one flat decode_blocks_batch: bytes equal the input, adler32 per
    shard equals zlib's, each decode kernel launched once."""
    from deflate_compression_tpu_torch.core.checksum import adler32_torch
    S = 4 << 20
    raw = corpus.build_corpus(S + 1_000_003, seed=21)
    valid = [S, len(raw) - S]
    rs = []
    for i, v in enumerate(valid):
        buf = np.zeros(S, np.uint8)
        buf[:v] = np.frombuffer(raw[i * S:i * S + v], np.uint8)
        rs.append(td.encode_shard(torch.from_numpy(buf).to(cuda), v, i == 1))
    blob = b"".join(td.shard_bytes(r) for r in rs)
    assert zlib.decompress(blob, wbits=-15) == raw
    b = [torch.stack([r[k] for r in rs]) for k in BATCH_KEYS]
    ds0, lg0 = DS.decode_symbols.launches, LG.lut_gather.launches
    res = DI.decode_blocks_batch(*b, valid, S)
    torch.cuda.synchronize()
    assert (DS.decode_symbols.launches, LG.lut_gather.launches) == \
        (ds0 + 1, lg0 + 1)
    assert bool(res["ok"])
    out = res["out"].cpu().numpy()
    for i, v in enumerate(valid):
        part = raw[i * S:i * S + v]
        assert out[i, :v].tobytes() == part
        assert int(adler32_torch(res["out"][i], v)) == zlib.adler32(part)


BATCH_KEYS = ("words", "block_bit_base", "block_out_start", "btype",
              "n_blocks", "sub_bit", "sub_out", "sub_blk")


def _batch(size=1 << 18):
    kinds = [("text", size), ("mixed", size - 4321), ("random", size - 9)]
    rs, valid = [], []
    for i, (k, v) in enumerate(kinds):
        x = torch.from_numpy(corpus.sample(k, size, seed=i))
        rs.append(td.encode_shard(x, v, i == len(kinds) - 1))
        valid.append(v)
    return {k: torch.stack([r[k] for r in rs]) for k in BATCH_KEYS}, valid


@pytest.mark.cuda
def test_decode_symbols_kernel_matches_plain(cuda):
    b, valid = _batch()
    S = 1 << 18
    flat = DI.flat_batch(*(b[k].to(cuda) for k in BATCH_KEYS), valid, S)
    p = DI.plan(**flat)
    args = DI.phase_b_args(p, len(valid) * S, 32768)
    before = DS.decode_symbols.launches
    got = DS.decode_symbols(*args)
    torch.cuda.synchronize()
    assert DS.decode_symbols.launches == before + 1
    want = DS.decode_symbols_ref(*args)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert bool(got.done[p.ln.llive].all())


def _foreign_args(cuda, mutate=0):
    """decode_symbols arguments on the card for a zlib-9 stream of skewed
    bytes (codes over 11 bits), with `mutate` seeded bit flips."""
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"abcdefgh" * 4 + b"\x00" * 200, np.uint8)
    raw = rng.choice(alphabet, 300_000).tobytes()
    body = zlib.compress(raw, 9)[2:-4]
    idx = tidx.build_index(body, prefer_native=False)
    words = np.frombuffer(body + bytes(-len(body) % 4 + 4), np.int32).copy()
    for _ in range(mutate):
        i = int(rng.integers(0, len(words) - 1))
        words[i] ^= np.int32(1 << int(rng.integers(0, 31)))
    p = DI.plan(torch.from_numpy(words).to(cuda), idx.bit_base, idx.out_start,
                idx.btype.astype(np.int64), idx.n_blocks, idx.sub_bit,
                idx.sub_out, idx.sub_blk.astype(np.int64), idx.n_subs,
                idx.out_len)
    return DI.phase_b_args(p, idx.out_len, 32768)


def _same_symbols(args):
    before = DS.decode_symbols.launches
    got = DS.decode_symbols(*args)
    torch.cuda.synchronize()
    assert DS.decode_symbols.launches == before + 1
    want = DS.decode_symbols_ref(*args)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mutate", [0, 1, 8])
def test_decode_symbols_kernel_foreign_15bit_stream(cuda, mutate):
    """A zlib-9 stream with codes over 11 bits (the long-code walk), clean
    and with seeded bit flips: the kernel equals its plain version."""
    got = _same_symbols(_foreign_args(cuda, mutate))
    if not mutate:
        assert not bool(got.bad.any())


@pytest.mark.cuda
def test_decode_symbols_kernel_block_over_one_cta(cuda):
    """A fixed-Huffman stream of blocks with more lanes than one CTA takes
    (THREADS): a block's lanes go to several CTAs, and CTAs hold lanes of
    two blocks."""
    raw = bytes(np.random.default_rng(4).integers(97, 123, 200_000,
                                                  dtype=np.uint8))
    co = zlib.compressobj(1, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    body = co.compress(raw) + co.flush()
    idx = tidx.build_index(body, sub_size=16)
    per_block = np.bincount(idx.sub_blk)
    assert per_block.max() > DS.THREADS
    words = np.frombuffer(body + bytes(-len(body) % 4 + 4), np.int32)
    p = DI.plan(torch.from_numpy(words.copy()).to(cuda), idx.bit_base,
                idx.out_start, idx.btype.astype(np.int64), idx.n_blocks,
                idx.sub_bit, idx.sub_out, idx.sub_blk.astype(np.int64),
                idx.n_subs, idx.out_len)
    got = _same_symbols(DI.phase_b_args(p, idx.out_len, 32768))
    assert bool(got.done[p.ln.llive].all())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_decode_symbols_kernel_lanes_in_any_order(cuda, order):
    """Lanes listed out of block order: CTAs hold lanes of many blocks and
    stage their tables over several rounds; the result is the same."""
    b, valid = _batch()
    S = 1 << 18
    flat = DI.flat_batch(*(b[k].to(cuda) for k in BATCH_KEYS), valid, S)
    args = list(DI.phase_b_args(DI.plan(**flat), len(valid) * S, 32768))
    NL = args[1].shape[0]
    perm = (torch.arange(NL - 1, -1, -1) if order == "reversed" else
            torch.from_numpy(np.random.default_rng(1).permutation(NL)))
    perm = perm.to(cuda)
    for i in range(1, 6):
        args[i] = args[i][perm].contiguous()
    _same_symbols(args)


@pytest.mark.cuda
def test_wrappers_do_not_synchronize(cuda):
    """Both redesigned wrappers launch with no host synchronisation."""
    sym = _hist_rows(32, 32768, 286, torch.int64, 1)
    args = _foreign_args(cuda)
    H.tile_histogram(sym, 286)
    DS.decode_symbols(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = H.tile_histogram(sym, 286)
        res = DS.decode_symbols(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(hist, H.tile_histogram_ref(sym, 286))
    for g, x in zip(res, DS.decode_symbols_ref(*args)):
        assert torch.equal(g, x)


@pytest.mark.cuda
def test_lut_gather_kernel_matches_take(cuda):
    rng = np.random.default_rng(5)
    tbl = torch.from_numpy(rng.integers(-2**31, 2**31, 2048)
                           .astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 2048, 4096)
                           .astype(np.int32)).to(cuda)
    before = LG.lut_gather.launches
    got = LG.lut_gather(tbl, idx)
    torch.cuda.synchronize()
    assert LG.lut_gather.launches == before + 1
    assert torch.equal(got, LG.lut_gather_ref(tbl, idx))


def _gather_case(cuda, n_tbl, n_idx, seed, skip=0):
    rng = np.random.default_rng(seed)
    tbl = torch.from_numpy(rng.integers(-2**31, 2**31, n_tbl)
                           .astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n_tbl, n_idx + skip)
                           .astype(np.int32)).to(cuda)
    return tbl, idx[skip:]


def _same_gather(tbl, idx):
    """The kernel equals tbl[idx] exactly and counts one launch (none for
    an empty idx, where nothing is launched)."""
    before = LG.lut_gather.launches
    got = LG.lut_gather(tbl, idx)
    torch.cuda.synchronize()
    assert LG.lut_gather.launches == before + (idx.numel() > 0)
    assert got.shape == idx.shape and got.dtype == torch.int32
    assert torch.equal(got, LG.lut_gather_ref(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n_idx", [0, 1, 5, 1023, 4096, 1 << 20])
def test_lut_gather_kernel_index_counts(cuda, n_idx):
    _same_gather(*_gather_case(cuda, 2048, n_idx, n_idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tbl", [1, 2, 2048, 32768, 65536, 1 << 20])
def test_lut_gather_kernel_table_sizes(cuda, n_tbl):
    _same_gather(*_gather_case(cuda, n_tbl, 1 << 16, n_tbl))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tbl,n_idx", [(512, 147456), (4, 999),
                                         (32768, 1 << 20), (1 << 24, 4097)])
def test_lut_gather_kernel_shapes(cuda, n_tbl, n_idx):
    _same_gather(*_gather_case(cuda, n_tbl, n_idx, n_idx))


@pytest.mark.cuda
def test_lut_gather_kernel_sorted_indices_and_out_of_range_bits(cuda):
    """Sorted block ids, as the decoder's lanes give them; and indices
    outside the table read tbl[idx & (n - 1)] and never past it."""
    tbl, idx = _gather_case(cuda, 512, 147456, 4)
    _same_gather(tbl, idx.sort().values)
    wide = idx | (1 << 20)
    assert torch.equal(LG.lut_gather(tbl, wide), LG.lut_gather_ref(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [1, 2, 3])
def test_lut_gather_kernel_unaligned_views(cuda, skip):
    """idx and tbl views that start `skip` elements in: not 16-byte
    aligned, so the kernel takes its scalar head and tail."""
    tbl, idx = _gather_case(cuda, 2048, 100_003, skip, skip)
    _same_gather(tbl, idx)
    base = torch.cat([tbl[:skip], tbl])
    _same_gather(base[skip:], idx)
    _same_gather(tbl, idx[:skip + 2])


@pytest.mark.cuda
def test_lanes_past_old_block_cap_cuda_matches_cpu(cuda):
    a, args, _ = lanes_case(40_000, 2)
    before = LG.lut_gather.launches
    g = DI.lanes(DI.PhaseA(*(x if x is None else x.to(cuda) for x in a)),
                 *(x.to(cuda) for x in args))
    torch.cuda.synchronize()
    assert LG.lut_gather.launches == before + 1
    c = DI.lanes(a, *args)
    for k in c._fields:
        assert torch.equal(getattr(g, k).cpu(), getattr(c, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("mutate", [False, True])
def test_decode_blocks_batch_cuda_matches_cpu(cuda, mutate):
    b, valid = _batch()
    S = 1 << 18
    if mutate:
        rng = np.random.default_rng(3)
        w = b["words"].clone()
        for _ in range(6):
            s = int(rng.integers(0, 2))
            w[s, int(rng.integers(0, 4000))] ^= 1 << int(rng.integers(0, 31))
        b["words"] = w
    args = [b[k] for k in BATCH_KEYS]
    before = DS.decode_symbols.launches
    g = DI.decode_blocks_batch(*(x.to(cuda) for x in args), valid, S)
    torch.cuda.synchronize()
    assert DS.decode_symbols.launches == before + 1
    c = DI.decode_blocks_batch(*args, valid, S)
    assert bool(g["ok"]) == bool(c["ok"]) == (not mutate)
    assert torch.equal(g["bad_lanes"].cpu(), c["bad_lanes"])
    assert torch.equal(g["out"].cpu(), c["out"])


@pytest.mark.cuda
def test_decompress_indexed_cuda_long_codes(cuda):
    """A zlib-9 stream of skewed bytes has codes over 11 bits: the kernel's
    long-code walk on the card."""
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"abcdefgh" * 4 + b"\x00" * 200, np.uint8)
    raw = rng.choice(alphabet, 300_000).tobytes()
    z = zlib.compress(raw, 9)
    body = z[2:-4]
    idx = tidx.build_index(body, prefer_native=False)
    before = DS.decode_symbols.launches
    out = tidx.decompress_indexed(body, idx, shard_out=1 << 17,
                                  expected_adler=zlib.adler32(raw),
                                  device="cuda")
    assert out == raw
    assert DS.decode_symbols.launches > before
