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
from deflate_compression_tpu_torch.ops import block_layout as BL
from deflate_compression_tpu_torch.ops import block_plan as BP
from deflate_compression_tpu_torch.ops import decode_symbols as DS
from deflate_compression_tpu_torch.ops import huffman_codes as HC
from deflate_compression_tpu_torch.ops import histogram as H
from deflate_compression_tpu_torch.ops import lut_gather as LG
from deflate_compression_tpu_torch.ops import pack_words as PW
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
    fns = (H.tile_histogram, FM.find_matches, LP.lz_parse,
           BP.block_plan, HC.huffman_codes, BL.block_layout, PW.pack_words)
    before = [f.launches for f in fns]
    g = td.encode_shard(x.to(cuda), valid_len, final)
    assert [f.launches - n for f, n in zip(fns, before)] == [2, 1, 1, 1, 2, 0,
                                                             1]
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
    fns = (H.tile_histogram, FM.find_matches, LP.lz_parse)
    before = [f.launches for f in fns]
    got = per_symbol_trace_csv(raw, device="cuda", **kw)
    # tokenize only
    assert [f.launches - n for f, n in zip(fns, before)] == [0, 1, 1]
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
    """Both redesigned wrappers, and find_matches and lz_parse (tokenize),
    launch with no host synchronisation."""
    sym = _hist_rows(32, 32768, 286, torch.int64, 1)
    args = _foreign_args(cuda)
    x = torch.from_numpy(corpus.sample("mixed", 1 << 20, seed=3)).to(cuda)
    H.tile_histogram(sym, 286)
    DS.decode_symbols(*args)
    TL.tokenize(x, 1_000_000)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = H.tile_histogram(sym, 286)
        res = DS.decode_symbols(*args)
        matches = FM.find_matches(x, 32)
        tok = LP.lz_parse(x, *matches, 1_000_000, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(hist, H.tile_histogram_ref(sym, 286))
    for g, x_ in zip(res, DS.decode_symbols_ref(*args)):
        assert torch.equal(g, x_)
    for g, x_ in zip(matches, FM.find_matches_ref(x, 32)):
        assert torch.equal(g, x_)
    want = LP.lz_parse_ref(x, *matches, 1_000_000, True)
    for key in want:
        assert torch.equal(tok[key], want[key]), key


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


# ------------------------------------------- build_tables and copy_sources


def first_symbol_16_words() -> np.ndarray:
    """A dynamic block header (u32 words) whose code-length code holds
    symbols 0 and 16 at one bit each and whose first code-length symbol is
    16: a repeat with no previous length."""
    bits, n = 0, 0
    for value, nbits in ((1, 1), (2, 2), (0, 5), (0, 5), (0, 4),
                         (1, 3), (0, 3), (0, 3), (1, 3),   # 16, 17, 18, 0
                         (1, 1), (2, 2),                   # 16, repeat 5
                         (0, 1), (0, 1)):
        bits |= value << n
        n += nbits
    body = bits.to_bytes(8, "little")
    return np.frombuffer(body, "<u4").copy()


def long_run_case(bad: bool, tiles: int = 7):
    """resolve_bytes arguments (CPU tensors) of hand-made tokens: literal
    65 at 0, then matches of length 258 and distance 1 to the end, one run
    over `tiles` tiles of the kernel; with `bad` the first token is a match
    that reaches before the output start. Returns (args, S)."""
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    S = tiles * CS.TILE + 17
    tok = np.zeros(S + 1, np.int32)
    tok[0] = (3 | (5 << 9) | (3 << 25)) if bad else (65 | (1 << 25))
    tok[(3 if bad else 1):S:258] = 258 | (1 << 9) | (3 << 25)
    t = torch.tensor
    return (torch.zeros(4, dtype=torch.int64), torch.from_numpy(tok),
            t([0]), t([0]), t([S]), t([True]), t([False])), S

from deflate_compression_tpu_torch.ops import build_tables as BT  # noqa: E402
from deflate_compression_tpu_torch.ops import copy_sources as CS  # noqa: E402
from deflate_compression_tpu_torch.ops import cuda_build  # noqa: E402


def _same_tables(w, blk_bit, blk_btype, n_blocks):
    """build_tables on the card equals its plain version in every field of
    every block slot, and counts one launch."""
    before = BT.build_tables.launches
    got = BT.build_tables(w, blk_bit, blk_btype, n_blocks)
    torch.cuda.synchronize()
    assert BT.build_tables.launches == before + 1
    want = BT.build_tables_ref(w, blk_bit, blk_btype, n_blocks)
    for k, g, x in zip(want.tables._fields, got.tables, want.tables):
        assert g.dtype == x.dtype and torch.equal(g, x), k
    for k in ("hdr_end", "bbad", "blive", "huff", "is_sto"):
        g, x = getattr(got, k), getattr(want, k)
        assert g.dtype == x.dtype and torch.equal(g, x), k
    return got


def _bytes_args(p, tok):
    return (p.w, tok, p.blk_bit, p.blk_out, p.blk_end, p.a.blive, p.a.is_sto)


def _same_bytes(args, S, prefix=None, plen=None, valid_out=None):
    """resolve_bytes on the card equals its plain version: the bytes,
    bad_dist and unconverged; one launch."""
    before = CS.resolve_bytes.launches
    got = CS.resolve_bytes(*args, S, prefix, plen, valid_out)
    torch.cuda.synchronize()
    assert CS.resolve_bytes.launches == before + 1
    want = CS.resolve_bytes_ref(*args, S, prefix, plen, valid_out)
    assert got[0].dtype == torch.uint8 and got[0].shape == (S,)
    diff = torch.nonzero(got[0] != want[0]).flatten()
    assert diff.numel() == 0, (diff[:8].tolist(), diff.numel())
    assert bool(got[1]) == bool(want[1]) and bool(got[2]) == bool(want[2])
    return got


def _flat_plan_cuda(cuda, mutate=0, size=1 << 18):
    b, valid = _batch(size)
    if mutate:
        rng = np.random.default_rng(mutate)
        w = b["words"].clone()
        for _ in range(mutate):
            s = int(rng.integers(0, 3))
            w[s, int(rng.integers(0, 300))] ^= 1 << int(rng.integers(0, 31))
        b["words"] = w
    flat = DI.flat_batch(*(b[k].to(cuda) for k in BATCH_KEYS), valid, size)
    return flat, len(valid) * size


@pytest.mark.cuda
@pytest.mark.parametrize("mutate", [0, 5, 40])
def test_build_tables_kernel_flat_batch(cuda, mutate):
    """The encoder's own index (dynamic and stored blocks, dead slots),
    clean and with seeded bit flips in the first words of each shard,
    where the block headers lie."""
    flat, _ = _flat_plan_cuda(cuda, mutate)
    a = _same_tables(DI._words(flat["comp_words"]), flat["blk_bit"],
                     flat["blk_btype"],
                     torch.tensor(flat["n_blocks"], device=cuda))
    if not mutate:
        assert not bool(a.bbad.any()) and bool(a.is_sto.any())
        assert bool(a.huff.any()) and not bool(a.blive.all())


def _foreign_index(cuda, level=9, strategy=zlib.Z_DEFAULT_STRATEGY):
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"abcdefgh" * 4 + b"\x00" * 200, np.uint8)
    raw = rng.choice(alphabet, 300_000).tobytes()
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    body = co.compress(raw) + co.flush()
    idx = tidx.build_index(body, prefer_native=False)
    words = np.frombuffer(body + bytes(-len(body) % 4 + 4), np.int32).copy()
    return raw, idx, words


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zlib9", "fixed", "stored"])
@pytest.mark.parametrize("mutate", [0, 30])
def test_build_tables_kernel_foreign_streams(cuda, kind, mutate):
    """zlib's own streams: level 9 (codes up to 15 bits, LONG_CODE
    entries), Z_FIXED and level 0 (stored); clean and with seeded bit
    flips at block headers."""
    _, idx, words = _foreign_index(
        cuda, 0 if kind == "stored" else 9,
        zlib.Z_FIXED if kind == "fixed" else zlib.Z_DEFAULT_STRATEGY)
    rng = np.random.default_rng(mutate)
    for _ in range(mutate):
        bit = int(idx.bit_base[rng.integers(0, idx.n_blocks)]) + int(
            rng.integers(0, 600))
        if (bit >> 5) < len(words):
            words[bit >> 5] ^= np.int32(1 << (bit & 31) if (bit & 31) < 31
                                        else -2**31)
    w = DI._words(torch.from_numpy(words).to(cuda))
    a = _same_tables(w, torch.from_numpy(idx.bit_base).to(cuda),
                     torch.from_numpy(idx.btype.astype(np.int64)).to(cuda),
                     idx.n_blocks)
    if kind == "zlib9" and not mutate:
        assert bool((a.tables.ll_lut == DS.LONG_CODE).any())
        assert not bool(a.bbad.any())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_build_tables_kernel_garbage(cuda, seed):
    """Random words parsed as headers at random bit offsets (some before,
    at and past the end of the words), every BTYPE, dead slots: the kernel
    equals the plain version on blocks that go bad in every way."""
    rng = np.random.default_rng(seed)
    CW, NB = 700, 900
    w = torch.from_numpy(rng.integers(0, 2**32, CW, dtype=np.uint64)
                         .astype(np.int64)).to(cuda)
    bit = rng.integers(0, 32 * CW, NB)
    bit[:40] = rng.integers(32 * CW - 200, 32 * CW + 5000, 40)
    bit[40:50] = rng.integers(-5000, 0, 10)
    bt = rng.choice([-1, 0, 1, 2, 2, 2, 2, 3], NB)
    a = _same_tables(w, torch.from_numpy(bit).to(cuda),
                     torch.from_numpy(bt).to(cuda),
                     torch.tensor(NB - 50, device=cuda))
    assert bool(a.bbad.any()) and bool((~a.bbad & a.huff).any())


@pytest.mark.cuda
def test_build_tables_kernel_repeat_without_previous(cuda):
    """A dynamic header whose first code-length symbol is 16: bad, and the
    tables of absent lengths."""
    w = torch.from_numpy(first_symbol_16_words().astype(np.int64)).to(cuda)
    a = _same_tables(w, torch.zeros(1, dtype=torch.int64, device=cuda),
                     torch.full((1,), 2, dtype=torch.int64, device=cuda), 1)
    assert bool(a.bbad[0])


def _plan_and_tokens(flat, S):
    p = DI.plan(**flat)
    return p, DI.phase_b(p, S, 32768).tok


@pytest.mark.cuda
@pytest.mark.parametrize("mutate", [0, 3, 40])
def test_resolve_bytes_kernel_flat_batch(cuda, mutate):
    flat, S = _flat_plan_cuda(cuda, mutate)
    p, tok = _plan_and_tokens(flat, S)
    _same_bytes(_bytes_args(p, tok), S)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zlib9", "fixed", "stored"])
def test_resolve_bytes_kernel_foreign_streams_with_prefix(cuda, kind):
    """zlib's streams through decompress_indexed (groups of whole blocks,
    each after the first with a 32 KB prefix) equal the input; then one
    decode with a prefix of random bytes, the kernel against the plain
    version at several prefix lengths."""
    raw, idx, words = _foreign_index(
        cuda, 0 if kind == "stored" else 9,
        zlib.Z_FIXED if kind == "fixed" else zlib.Z_DEFAULT_STRATEGY)
    body = words.tobytes()
    a0, c0 = BT.build_tables.launches, CS.resolve_bytes.launches
    assert tidx.decompress_indexed(
        body, idx, shard_out=1 << 16, expected_adler=zlib.adler32(raw),
        device="cuda") == raw
    assert BT.build_tables.launches > a0
    assert CS.resolve_bytes.launches > c0
    # one group with a prefix, the kernel against the plain version
    S = 40_000 + 32768
    rng = np.random.default_rng(1)
    prefix = torch.from_numpy(rng.integers(0, 256, 32768, dtype=np.uint8))
    p = DI.plan(torch.from_numpy(words).to(cuda), idx.bit_base,
                idx.out_start + 32768, idx.btype.astype(np.int64),
                idx.n_blocks, idx.sub_bit, idx.sub_out + 32768,
                idx.sub_blk.astype(np.int64), idx.n_subs, S)
    tok = DI.phase_b(p, S, 32768).tok
    for plen in (32768, torch.tensor(20_000, device=cuda), 0):
        _same_bytes(_bytes_args(p, tok), S, prefix.to(cuda), plen)
    _same_bytes(_bytes_args(p, tok), S, prefix[:100].to(cuda), 32768)


@pytest.mark.cuda
def test_resolve_bytes_kernel_long_run_and_bad_dist(cuda):
    """A zero run over many tiles (one run, one step), and a stream whose
    first match reaches before the output start."""
    for bad in (False, True):
        args, S = long_run_case(bad)
        got = _same_bytes(tuple(x.to(cuda) for x in args), S)
        assert bool(got[1]) == bad


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_resolve_bytes_kernel_random_tokens_and_blocks(cuda, seed):
    """Random token arrays (literals, matches of any distance, gaps of any
    length) over random block tables (overlapping, unsorted, dead, stored
    blocks that overlap each other): exact equality, bad_dist included.
    Seeds 6 and 7 start thousands of blocks in a few tiles, more than a
    tile keeps in shared memory."""
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 300_000)) if seed else 5000
    NB = int(rng.integers(1, 60)) if seed < 6 else 3000
    if seed >= 6:
        S = 5 * CS.TILE + 99
    CW = 4000
    kind = rng.random(S + 1)
    gap = rng.random() * 0.9
    lit = rng.integers(0, 256, S + 1)
    dist = np.where(rng.random(S + 1) < 0.5, rng.integers(1, 40, S + 1),
                    rng.integers(1, 40_000, S + 1))
    tok = np.where(kind < gap, 0, np.where(
        kind < gap + (1 - gap) / 2, lit | (1 << 25),
        rng.integers(3, 259, S + 1) | (dist << 9) | (3 << 25)))
    if seed % 2:
        tok[S // 3:2 * S // 3] = 0            # a long region with no token
    out = rng.integers(-100, S + 100, NB)
    if seed % 3:
        out = np.sort(out)
    end = out + rng.integers(-10, 70_000 if seed < 4 else S, NB)
    t = torch.from_numpy
    args = (t(rng.integers(0, 2**32, CW, dtype=np.uint64).astype(np.int64)),
            t(tok.astype(np.int32)), t(rng.integers(0, 32 * CW + 64, NB)),
            t(out), t(end), t(rng.random(NB) < 0.8))
    is_sto = args[-1] & t(rng.random(NB) < 0.4)
    args = tuple(x.to(cuda) for x in (*args, is_sto))
    _same_bytes(args, S)
    prefix = t(rng.integers(0, 256, 32768, dtype=np.uint8)).to(cuda)
    _same_bytes(args, S, prefix, int(rng.integers(0, min(S, 32768) + 1)))


@pytest.mark.cuda
def test_phase_wrappers_do_not_synchronize(cuda):
    """build_tables and resolve_bytes launch with no host synchronisation
    when their scalars are ints or already on the card."""
    flat, S = _flat_plan_cuda(cuda)
    p, tok = _plan_and_tokens(flat, S)
    w = p.w
    nb = torch.tensor(flat["n_blocks"], device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = BT.build_tables(w, p.blk_bit, flat["blk_btype"], nb)
        r = CS.resolve_bytes(*_bytes_args(p, tok), S)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for g, x in zip(a.tables, p.a.tables):
        assert torch.equal(g, x)
    assert torch.equal(r[0], CS.resolve_bytes_ref(*_bytes_args(p, tok), S)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mod", ["build_tables", "copy_sources",
                                 "find_matches", "lz_parse"])
def test_phase_kernels_raise_when_the_library_cannot_load(cuda, mod,
                                                          monkeypatch):
    """No fallback: on CUDA tensors a wrapper whose library does not build
    raises, and never takes the plain version."""
    flat, S = _flat_plan_cuda(cuda, size=1 << 16)
    p, tok = _plan_and_tokens(flat, S)
    x = torch.from_numpy(corpus.sample("mixed", 1 << 16, seed=1)).to(cuda)
    zeros = torch.zeros(1 << 16, dtype=torch.int64, device=cuda)
    m, ref, call = {
        "build_tables": (BT, "build_tables_ref", lambda: BT.build_tables(
            p.w, p.blk_bit, flat["blk_btype"], flat["n_blocks"])),
        "copy_sources": (CS, "resolve_bytes_ref",
                         lambda: CS.resolve_bytes(*_bytes_args(p, tok), S)),
        "find_matches": (FM, "find_matches_ref",
                         lambda: TL.tokenize(x, 1 << 16)),
        "lz_parse": (LP, "lz_parse_ref",
                     lambda: LP.lz_parse(x, zeros, zeros, 1 << 16))}[mod]

    def boom(*a, **k):
        raise RuntimeError("nvcc failed (test)")
    m._bind.cache_clear()
    monkeypatch.setattr(cuda_build, "load", boom)
    monkeypatch.setattr(m, ref, None)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    finally:
        m._bind.cache_clear()


@pytest.mark.cuda
def test_decode_launches_all_four_decode_kernels(cuda):
    """decode_blocks_batch on CUDA tensors launches build_tables,
    lut_gather, decode_symbols and copy_sources once each."""
    b, valid = _batch()
    fns = (BT.build_tables, LG.lut_gather, DS.decode_symbols,
           CS.resolve_bytes)
    before = [f.launches for f in fns]
    g = DI.decode_blocks_batch(*(b[k].to(cuda) for k in BATCH_KEYS), valid,
                               1 << 18)
    assert bool(g["ok"])
    assert [f.launches for f in fns] == [n + 1 for n in before]


def dynamic_header_words(seq, clen_lens, hlit=286, hdist=30, lead=0,
                         tail_words=2) -> tuple:
    """A dynamic block header as u32 words (int64) after `lead` zero bits:
    BFINAL 1, BTYPE 2, HLIT/HDIST, HCLEN 19 (all 19 code-length lengths
    sent), then the code-length symbols `seq` [(symbol, extra bits)] in the
    canonical code of `clen_lens` (per symbol 0-18), then `tail_words`
    zero words. Returns (words, the header's bits after BTYPE)."""
    from deflate_compression_tpu_torch.core.huffman import canonical_codes_np
    from deflate_compression_tpu_torch.format import constants as C
    codes = canonical_codes_np(np.asarray(clen_lens, np.int64), 7)

    def rev(code, n):
        return int(format(int(code), f"0{n}b")[::-1], 2)
    fields = [(1, 1), (2, 2), (hlit - 257, 5), (hdist - 1, 5), (15, 4)]
    fields += [(clen_lens[C.CLEN_ORDER[j]], 3) for j in range(19)]
    for s, ev in seq:
        fields.append((rev(codes[s], clen_lens[s]), clen_lens[s]))
        eb = {16: 2, 17: 3, 18: 7}.get(s, 0)
        if eb:
            fields.append((ev, eb))
    bits, n = 0, lead
    for value, nb in fields:
        bits |= value << n
        n += nb
    n_words = (n + 31) // 32 + tail_words
    words = np.frombuffer(bits.to_bytes(4 * n_words, "little"), "<u4")
    return words.astype(np.int64), n - lead - 3


# complete code-length codes: literals 6 and 7 in 7 bits; and 16 in 6
# bits, 17 and 18 in 7 bits beside literals 1, 2, 3, 4 and 9
CLEN_LITERALS = [1, 2, 3, 4, 5, 6, 7, 7] + [0] * 11
CLEN_REPEATS = [0, 1, 2, 4, 5, 0, 0, 0, 0, 3] + [0] * 6 + [6, 7, 7]
REPEATS = {16: (3, 2), 17: (3, 3), 18: (11, 7)}   # base, extra bits


def _header_case(kind: str, lead: int):
    """(words, header bits) of one hand-made dynamic header."""
    rng = np.random.default_rng(lead)
    if kind in ("longest", "at_end", "cut"):
        # 316 lengths, each a 7-bit code: the most bits a header can take
        seq = [(int(s), 0) for s in rng.choice([6, 7], 316)]
        w, n = dynamic_header_words(seq, CLEN_LITERALS, lead=lead,
                                    tail_words=2 if kind == "longest" else 0)
        if kind == "cut":                  # the words end inside the walk
            w = w[:len(w) // 2]
        return w, n
    seq, i = [(1, 0)], 1                   # repeats in 6- and 7-bit codes
    while i < 316:
        s = int(rng.choice([1, 2, 9, 16, 17, 18]))
        base, eb = REPEATS.get(s, (1, 0))
        ev = int(rng.integers(0, 1 << eb))
        if i + base + ev <= 316:
            seq.append((s, ev))
            i += base + ev
    return dynamic_header_words(seq, CLEN_REPEATS, lead=lead)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["longest", "at_end", "cut", "repeats"])
@pytest.mark.parametrize("lead", [0, 1, 29, 31, 32 * 40 + 5])
def test_build_tables_kernel_hand_made_headers(cuda, kind, lead):
    """Hand-made headers with HCLEN 19 and all 316 lengths: the longest a
    header can be (every length a 7-bit code), the same header ending on
    the last word of the stream (reads past it clip to that word) and cut
    by the end of the words (the bit budget), and repeat codes (16, 17,
    18) with random extra bits; at several bit offsets in the first word
    and 40 words in. No header reaches past the kernel's 152-word window:
    a step takes at most 7 bits per length it adds."""
    w, n_bits = _header_case(kind, lead)
    w = torch.from_numpy(w).to(cuda)
    bits = torch.tensor([lead, lead, lead - 7], device=cuda)
    a = _same_tables(w, bits, torch.tensor([2, -1, 2], device=cuda), 3)
    if kind == "cut":
        assert bool(a.bbad[0]) and int(a.hdr_end[0]) < lead + 3 + n_bits
    else:
        assert int(a.hdr_end[0]) == lead + 3 + n_bits


def _tokens(n: int) -> np.ndarray:
    return np.zeros(n + 1, np.int32)


def _tok_match(length: int, dist: int) -> int:
    return length | (dist << 9) | (3 << 25)


def _one_block(tok: np.ndarray, S: int):
    """resolve_bytes arguments (CPU tensors) of tokens in one live Huffman
    block over the whole output."""
    t = torch.tensor
    return (torch.zeros(4, dtype=torch.int64), torch.from_numpy(tok),
            t([0]), t([0]), t([S]), t([True]), t([False]))


def _same_bytes_rounds(cuda, args, S, **kw):
    """_same_bytes on the card, and the gather rounds the kernel ran."""
    stats = {}
    got = CS.resolve_bytes(*(x.to(cuda) for x in args), S, stats=stats,
                           **kw)
    torch.cuda.synchronize()
    _same_bytes(tuple(x.to(cuda) for x in args), S, **kw)
    return got, stats["rounds"]


@pytest.mark.cuda
def test_resolve_bytes_kernel_pointers_inside_tiles(cuda):
    """Every tile starts with 128 literals and its matches reach at most
    100 back: every pointer resolves inside its tile, and the rounds
    kernel gathers nothing."""
    rng = np.random.default_rng(3)
    n_tiles = 11
    S = n_tiles * CS.TILE
    tok = _tokens(S)
    for base in range(0, S, CS.TILE):
        tok[base:base + 128] = rng.integers(0, 256, 128) | (1 << 25)
        p = base + 128
        while p < base + CS.TILE - 3:
            ln = int(rng.integers(3, min(60, base + CS.TILE - p) + 1))
            tok[p] = _tok_match(ln, int(rng.integers(1, 101)))
            p += ln
            if p < base + CS.TILE and rng.random() < 0.3:
                tok[p] = int(rng.integers(0, 256)) | (1 << 25)
                p += 1
    got, rounds = _same_bytes_rounds(cuda, _one_block(tok, S), S)
    assert rounds == 0 and not bool(got[1]) and not bool(got[2])


@pytest.mark.cuda
def test_resolve_bytes_kernel_4mb_zero_run(cuda):
    """A 4 MB run of distance 1 after one literal: one run over 2,048
    tiles, resolved in one gather round."""
    args, S = long_run_case(False, tiles=2048)
    got, rounds = _same_bytes_rounds(cuda, args, S)
    assert rounds == 1 and bool((got[0] == 65).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dist", [1, 32768, 0])
def test_resolve_bytes_kernel_chains_across_tile_edges(cuda, dist):
    """After 32 KB of random literals, literals and matches of distance 1
    or 32768 (0: both, at random) of random lengths, most runs crossing a
    tile edge: each match's source is a pointer, chains of many hops."""
    rng = np.random.default_rng(dist + 1)
    S = 60 * CS.TILE + 123
    tok = _tokens(S)
    tok[:32768] = rng.integers(0, 256, 32768) | (1 << 25)
    p = 32768
    while p < S:
        tok[p] = int(rng.integers(0, 256)) | (1 << 25)
        p += 1
        d = dist or int(rng.choice([1, 32768]))
        ln = int(rng.integers(3, 259))
        if p < S:
            tok[p] = _tok_match(ln, d)
        p += ln
    got, rounds = _same_bytes_rounds(cuda, _one_block(tok, S), S)
    assert rounds >= 1 and not bool(got[1]) and not bool(got[2])


@pytest.mark.cuda
def test_resolve_bytes_kernel_valid_out(cuda):
    """valid_out below out_size, as an int and as an int64 on the card
    (read there: no synchronisation): the bytes at or past it are 0, the
    rest as without it."""
    flat, S = _flat_plan_cuda(cuda)
    p, tok = _plan_and_tokens(flat, S)
    args = _bytes_args(p, tok)
    whole = _same_bytes(args, S)[0]
    for cut in (1, S // 3 + 1, S - 1, S):
        got = _same_bytes(args, S, valid_out=cut)[0]
        assert torch.equal(got[:cut], whole[:cut]) and not got[cut:].any()
    cut_t = torch.tensor(S // 2 + 3, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = CS.resolve_bytes(*args, S, valid_out=cut_t)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got, CS.resolve_bytes_ref(*args, S,
                                                 valid_out=cut_t)[0])


# ------------------------------------------------- find_matches and lz_parse

from deflate_compression_tpu_torch.core import lz77 as TL  # noqa: E402
from deflate_compression_tpu_torch.ops import find_matches as FM  # noqa: E402
from deflate_compression_tpu_torch.ops import lz_parse as LP  # noqa: E402

def _same_matches(data, k):
    before = FM.find_matches.launches
    got = FM.find_matches(data, k)
    torch.cuda.synchronize()
    assert FM.find_matches.launches == before + 1
    want = FM.find_matches_ref(data, k)
    for g, x in zip(got, want):
        assert g.dtype == torch.int64 and torch.equal(g, x)
    return got


def _same_parse(data, length, dist, valid_len, lazy):
    before = LP.lz_parse.launches
    got = LP.lz_parse(data, length, dist, valid_len, lazy)
    torch.cuda.synchronize()
    assert LP.lz_parse.launches == before + 1
    want = LP.lz_parse_ref(data, length, dist, valid_len, lazy)
    for key in ("chosen", "length", "dist"):
        assert got[key].dtype == want[key].dtype, key
        diff = torch.nonzero(got[key] != want[key]).flatten()
        assert diff.numel() == 0, (key, diff[:8].tolist(), diff.numel())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", corpus.LZ_CASES)
def test_lz77_kernels_match_plain_on_edge_cases(cuda, name):
    data, vl, lazy, k = corpus.lz_case(name)
    x = torch.from_numpy(data).to(cuda)
    length, dist = _same_matches(x, k)
    _same_parse(x, length, dist, vl, lazy)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,size", [
    *((k, 1 << 16) for k in ("text", "random", "periodic", "zeros", "rgb",
                             "cpp", "mixed")),
    ("mixed", 1 << 20), ("zeros", 1 << 20), ("mixed", 4 << 20)])
def test_lz77_kernels_match_plain_on_corpus_kinds(cuda, kind, size):
    x = torch.from_numpy(corpus.sample(kind, size, seed=2)).to(cuda)
    length, dist = _same_matches(x, 32)
    _same_parse(x, length, dist, size - 999, True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["long_chains", "parse_subtile", "s36865",
                                  "clamp_dist"])
def test_lz77_packed_hand_off_matches_plain(cuda, name):
    """find_matches_packed and lz_parse_packed (tokenize's path) against
    the plain versions: the packed matches equal pack(find_matches_ref),
    and the parse from them equals lz_parse_ref."""
    data, vl, lazy, k = corpus.lz_case(name)
    x = torch.from_numpy(data).to(cuda)
    before = (FM.find_matches.launches, LP.lz_parse.launches)
    packed = FM.find_matches_packed(x, k)
    got = LP.lz_parse_packed(x, packed, vl, lazy)
    torch.cuda.synchronize()
    assert (FM.find_matches.launches, LP.lz_parse.launches) == \
        (before[0] + 1, before[1] + 1)
    want_m = FM.find_matches_ref(x, k)
    assert torch.equal(packed, FM.pack(*want_m))
    want = LP.lz_parse_ref(x, *want_m, vl, lazy)
    for key in ("chosen", "length", "dist"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [1, 3, 8])
def test_lz77_kernels_unaligned_views(cuda, skip):
    """Views that start off a 16-byte boundary take the kernels' scalar
    staging: the same results, for the bytes and for the packed hand-off
    (a view 4 bytes past a boundary)."""
    base = torch.from_numpy(corpus.sample("mixed", 70_000 + skip,
                                          seed=skip)).to(cuda)
    x = base[skip:]
    length, dist = _same_matches(x, 32)
    _same_parse(x, length, dist, 65_000, True)
    buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda)
    buf[1:] = FM.pack(length, dist)
    got = LP.lz_parse_packed(x, buf[1:], 65_000, True)
    want = LP.lz_parse_ref(x, length, dist, 65_000, True)
    for key in ("chosen", "length", "dist"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.cuda
def test_tokenize_launches_each_kernel_once(cuda):
    x = torch.from_numpy(corpus.sample("mixed", 1 << 17, seed=8)).to(cuda)
    before = (FM.find_matches.launches, LP.lz_parse.launches)
    got = TL.tokenize(x, 100_000)
    assert (FM.find_matches.launches, LP.lz_parse.launches) == \
        (before[0] + 1, before[1] + 1)
    want = TL.tokenize(x.cpu(), 100_000)
    for key in ("chosen", "length", "dist"):
        assert torch.equal(got[key].cpu(), want[key]), key


# ------------------------------------------- the encoder's block stage

def _same_plan(cuda, ll, d, n_valid, tile_bytes, mm=8):
    ll, d, tb = (torch.as_tensor(x, dtype=torch.int64).to(cuda)
                 for x in (ll, d, tile_bytes))
    got_st, want_st = {}, {}
    before = BP.block_plan.launches
    split, nb = BP.block_plan(ll, d, n_valid, tb, mm, stats=got_st)
    w_split, w_nb = BP.block_plan_ref(ll, d, n_valid, tb, mm, stats=want_st)
    torch.cuda.synchronize()
    assert BP.block_plan.launches == before + 1
    assert torch.equal(split, w_split) and int(nb) == int(w_nb)
    torch.testing.assert_close(got_st["cost"], want_st["cost"], rtol=1e-5,
                               atol=0)
    # the margin is a difference of two candidates a few ulps apart
    torch.testing.assert_close(got_st["gap"], want_st["gap"], rtol=0, atol=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", corpus.BLOCK_PLAN_CASES)
def test_block_plan_kernel_matches_plain(cuda, name):
    ll, d, n_valid, tile_bytes = corpus.block_plan_case(name)
    _same_plan(cuda, ll, d, n_valid, tile_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("mm,n_valid", [(1, 32), (2, 31), (5, 32), (32, 32),
                                        (8, 0), (8, 1)])
def test_block_plan_kernel_merge_bounds(cuda, mm, n_valid):
    ll, d, _, tile_bytes = corpus.block_plan_case("m32")
    _same_plan(cuda, ll, d, n_valid, tile_bytes, mm)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3000])
def test_block_plan_kernel_tile_counts(cuda, M):
    """One tile, and more tiles than the DP stages in shared memory at
    once (3,000 of them, all below the float32-exact count of 2^24 /
    32768)."""
    ll, d = corpus.tile_histograms(M, M)
    ll //= 8
    d //= 8
    tile_bytes = np.full(M, 32768, np.int64)
    _same_plan(cuda, ll, d, M, tile_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("mm", [1, 3, 8, 32])
@pytest.mark.parametrize("M", [1, 2, 17, 32, 128, 600])
def test_block_plan_kernel_tiles_and_merge_bounds(cuda, M, mm):
    """The chain's two widths (8 for mm <= 8, 32 above), one and two CTAs
    of costs, a ragged last CTA, the main path's 32 and 128 tiles, and 600
    tiles: more rows than one DP stage holds (480 at mm <= 8, 96 above)."""
    ll, d = corpus.tile_histograms(M, M + mm)
    ll //= 8
    d //= 8
    tile_bytes = np.full(M, 32768, np.int64)
    tile_bytes[-1] = 1234
    _same_plan(cuda, ll, d, max(M - 1, 1), tile_bytes, mm)


@pytest.mark.cuda
@pytest.mark.parametrize("name", corpus.HUFFMAN_CASES)
def test_huffman_codes_kernel_matches_plain(cuda, name):
    freqs, max_bits = corpus.huffman_case(name)
    _same_codes(torch.from_numpy(freqs).to(cuda), max_bits)


def _same_codes(freqs, max_bits):
    before = HC.huffman_codes.launches
    got = HC.huffman_codes(freqs, max_bits)
    want = HC.huffman_codes_ref(freqs, max_bits)
    torch.cuda.synchronize()
    assert HC.huffman_codes.launches == before + 1
    for g, w, what in zip(got, want, got._fields):
        assert g.dtype == torch.int64 and torch.equal(g, w), what
    assert int(got.lengths.max()) <= max_bits


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_bits", [(19, 5), (286, 9), (300, 11)] + [
    (n, b) for n in (1, 2, 19, 30, 286, 512) for b in (1, 7, 11, 15)])
def test_huffman_codes_kernel_alphabets(cuda, n, max_bits):
    """Random, sparse, heavy-tailed and tied rows, one and two used
    symbols and frequencies at and above 2^28, of other sizes and limits
    (the limit large enough for every used symbol)."""
    freqs = corpus.huffman_rows(n, max_bits)
    _same_codes(torch.from_numpy(freqs).to(cuda), max_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", corpus.LAYOUT_CASES)
def test_block_layout_kernel_matches_plain(cuda, name):
    rest, stored = (torch.from_numpy(x).to(cuda)
                    for x in corpus.layout_case(name))
    before = BL.block_layout.launches
    got = BL.block_layout(rest, stored)
    want = BL.block_layout_ref(rest, stored)
    torch.cuda.synchronize()
    assert BL.block_layout.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("btype,plans", [(0, 0), (1, 0), (2, 1)])
def test_encode_shard_forced_btype_launches(cuda, btype, plans):
    """Forced fixed or stored blocks skip the DP; the codes and the pack
    (whose look-back carries the layout) run in every encode."""
    x = torch.from_numpy(corpus.sample("mixed", 1 << 18, seed=2))
    fns = (BP.block_plan, HC.huffman_codes, BL.block_layout, PW.pack_words)
    before = [f.launches for f in fns]
    g = td.encode_shard(x.to(cuda), 250_000, True, force_btype=btype)
    assert [f.launches - n for f, n in zip(fns, before)] == [plans, 2, 0, 1]
    c = td.encode_shard(x, 250_000, True, force_btype=btype)
    for k in c:
        assert torch.equal(g[k].cpu(), c[k]), k


@pytest.mark.cuda
def test_block_stage_wrappers_do_not_synchronize(cuda):
    ll, d, n_valid, tile_bytes = (torch.as_tensor(x).to(cuda) if
                                  isinstance(x, np.ndarray) else x
                                  for x in corpus.block_plan_case("m32"))
    freqs = torch.from_numpy(corpus.huffman_case("litlen_11")[0]).to(cuda)
    rest, stored = (torch.from_numpy(x).to(cuda)
                    for x in corpus.layout_case("nb32"))
    BP.block_plan(ll, d, n_valid, tile_bytes)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = BP.block_plan(ll, d, n_valid, tile_bytes)
        codes = HC.huffman_codes(freqs, 11)
        lay = BL.block_layout(rest, stored)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(plan[0], BP.block_plan_ref(ll, d, n_valid,
                                                  tile_bytes)[0])
    assert torch.equal(codes.rev, HC.huffman_codes_ref(freqs, 11).rev)
    assert torch.equal(lay[0], BL.block_layout_ref(rest, stored)[0])


# ------------------------------------------------------------ the bit-pack

def _same_pack(a, final, nw):
    """pack_words on the card against its plain version on the same
    arguments: every field exactly, and one launch."""
    before = PW.pack_words.launches
    got = PW.pack_words(*a, final, nw)
    want = PW.pack_words_ref(*a, final, nw)
    torch.cuda.synchronize()
    assert PW.pack_words.launches == before + 1
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", corpus.PACK_CASES)
def test_pack_words_kernel_matches_plain_on_synthetic_shards(cuda, name):
    *args, final, nw = corpus.pack_case(name)
    _same_pack([torch.from_numpy(x).to(cuda) for x in args], final, nw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,size,valid_len,final,btype", [
    ("mixed", 1 << 20, 1 << 20, True, None),
    ("mixed", 1 << 20, 700_001, False, None),
    ("text", 4 << 20, (4 << 20) - 99, False, None),
    ("random", 1 << 18, 1 << 18, False, None),
    ("text", 1 << 18, 200_000, True, 0),
    ("mixed", 1 << 18, 1 << 18, False, 1),
    ("text", 32768, 1, True, None)])
def test_pack_words_kernel_matches_plain_on_encoder_shards(
        cuda, kind, size, valid_len, final, btype):
    x = torch.from_numpy(corpus.sample(kind, size, seed=5)).to(cuda)
    kw = {} if btype is None else {"force_btype": btype}
    _, _, a, _ = corpus.block_stage_inputs(x, valid_len, final,
                                           **kw)["pack_words"]
    got = _same_pack(a[:14], a[14], a[15])
    rest, stored = corpus.layout_inputs(a)
    lay = BL.block_layout(rest, stored)
    assert torch.equal(lay[0], got.block_base)
    assert torch.equal(lay[1], got.pad)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,stride,btype", [
    ("text", None, None), ("text", 1, None), ("periodic", 1, None),
    ("mixed", None, 0)])
def test_pack_words_kernel_4mb_shard_repeats(cuda, kind, stride, btype):
    """A 4 MB shard, 1,024 units: more than the card holds at once, so
    units wait on the look-back of units that started before them. The
    kernel equals the plain version and itself over 50 calls: with the
    encoder's stride; with stride 1 on text (more entries than NSUB: the
    overflow flag); with stride 1 on periodic data (every Huffman token an
    entry, NSUB not reached); with every block stored (no entry)."""
    n = 4 << 20
    x = torch.from_numpy(corpus.sample(kind, n, seed=3)).to(cuda)
    kw = {"_test_stride": stride} if stride else {}
    if btype is not None:
        kw["force_btype"] = btype
    _, _, a, _ = corpus.block_stage_inputs(x, n, False, **kw)["pack_words"]
    assert n // PW.UNIT > PW.resident_units(cuda)
    first = _same_pack(a[:14], a[14], a[15])
    for _ in range(50):
        got = PW.pack_words(*a)
        for field in first._fields:
            assert torch.equal(getattr(got, field),
                               getattr(first, field)), field
    chosen, blk, huff = a[1], a[4], a[6]
    n_tok_h = int((chosen & huff[blk].repeat_interleave(32768)).sum())
    n_ent = int((first.sub_blk >= 0).sum())
    if stride == 1 and kind == "text":
        assert bool(first.sub_overflow) and n_ent == n // 64 < n_tok_h
    elif stride == 1:
        assert not bool(first.sub_overflow) and n_ent == n_tok_h > 0
    elif btype == 0:
        assert n_tok_h == n_ent == 0 and not bool(first.sub_overflow)
    else:
        assert 0 < n_ent <= n // 64 and not bool(first.sub_overflow)


@pytest.mark.cuda
def test_pack_words_kernel_unaligned_inputs(cuda):
    """Inputs that do not start on a 16-byte edge are copied first."""
    *args, final, nw = corpus.pack_case("nb32")
    a = [torch.from_numpy(x).to(cuda) for x in args]
    for i in range(4):
        pad = torch.zeros(a[i].shape[0] + 3, dtype=a[i].dtype, device=cuda)
        pad[3:] = a[i]
        a[i] = pad[3:]
        assert a[i].data_ptr() % 16
    _same_pack(a, final, nw)


@pytest.mark.cuda
@pytest.mark.parametrize("nw_cut", [1, 5000, 0])
def test_pack_words_kernel_drops_bits_past_num_words(cuda, nw_cut):
    """With fewer words than the stream needs, both drop what lies past
    them (nw_cut words short; 0: the exact count)."""
    *args, final, _ = corpus.pack_case("nb32_final")
    a = [torch.from_numpy(x).to(cuda) for x in args]
    total = int(PW.pack_words_ref(*a, final, 1 << 22).total_bits)
    _same_pack(a, final, max(-(-total // 32) - nw_cut, 1))


@pytest.mark.cuda
def test_pack_words_does_not_synchronize(cuda):
    *args, final, nw = corpus.pack_case("nb128")
    a = [torch.from_numpy(x).to(cuda) for x in args]
    PW.pack_words(*a, final, nw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = PW.pack_words(*a, final, nw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got.words, PW.pack_words_ref(*a, final, nw).words)


@pytest.mark.cuda
def test_pack_words_raises_when_the_library_cannot_load(cuda, monkeypatch):
    *args, final, nw = corpus.pack_case("nb1")
    a = [torch.from_numpy(x).to(cuda) for x in args]

    def boom(*a_, **k):
        raise RuntimeError("nvcc failed (test)")
    PW._bind.cache_clear()
    monkeypatch.setattr(cuda_build, "load", boom)
    monkeypatch.setattr(PW, "pack_words_ref", None)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            PW.pack_words(*a, final, nw)
    finally:
        PW._bind.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 31, 33, 256, 257, 2049, 5000])
@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
def test_block_layout_kernel_block_counts(cuda, nb, share):
    """The scan over one chunk and over many, all, some and no blocks
    stored."""
    rng = np.random.default_rng(nb)
    stored = rng.random(nb) < share
    rest = np.where(stored, 35 + 8 * rng.integers(0, 32769, nb),
                    rng.integers(0, 300_000, nb)).astype(np.int64)
    r, s = torch.from_numpy(rest).to(cuda), torch.from_numpy(stored).to(cuda)
    got = BL.block_layout(r, s)
    want = BL.block_layout_ref(r.cpu(), s.cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------- adler32

from deflate_compression_tpu_torch.core import checksum as CK  # noqa: E402
from deflate_compression_tpu_torch.ops import adler32 as AD  # noqa: E402
from test_torch_adler32 import CASE_IDS, CASES, MIB, case_data  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("kind,size,n", CASES, ids=CASE_IDS)
def test_adler32_kernel_matches_plain_and_zlib(cuda, kind, size, n):
    data = case_data(kind, size)
    x = torch.from_numpy(data).to(cuda)
    want = zlib.adler32(data[:n].tobytes())
    before = AD.adler32.launches
    got = CK.adler32_torch(x, n)
    assert AD.adler32.launches == before + 1
    assert (got.device, got.dtype, got.dim()) == (x.device, torch.int64, 0)
    assert int(got) == want == int(CK.adler32_torch_ref(x, n))
    assert int(CK.adler32_torch(x, torch.tensor(n, device=cuda))) == want
    assert AD.adler32.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(16))
def test_adler32_kernel_unaligned_views(cuda, offset):
    """A view starting at every byte of a 16-byte line; its bytes before
    and after are nonzero."""
    data = case_data("random", 4 * MIB + 64, seed=offset)
    x = torch.from_numpy(data).to(cuda)[offset:]
    for n in (0, 1, 17, 5553, MIB + 1, 4 * MIB):
        want = zlib.adler32(data[offset:offset + n].tobytes())
        assert int(CK.adler32_torch(x, n)) == want, n
        assert int(CK.adler32_torch(
            x, torch.tensor(n, device=cuda))) == want, n


@pytest.mark.cuda
def test_adler32_kernel_rows_of_a_batch(cuda):
    """out[s] of a batch whose rows start at other alignments, as the
    verified decode checksums its shards."""
    rows, width = 5, 1_000_003
    data = case_data("random", rows * width)
    out = torch.from_numpy(data).to(cuda).view(rows, width)
    valid = [width, width - 1, 5552, 1, 0]
    got = torch.stack([CK.adler32_torch(out[s], v)
                       for s, v in enumerate(valid)])
    assert got.tolist() == [zlib.adler32(data[s * width:s * width + v]
                                         .tobytes())
                            for s, v in enumerate(valid)]


@pytest.mark.cuda
def test_adler32_kernel_length_on_the_card(cuda):
    data = case_data("random", 200_000)
    x = torch.from_numpy(data).to(cuda)
    for n in (0, 1, 99_999, 200_000):
        for dtype in (torch.int64, torch.int32):
            got = CK.adler32_torch(x, torch.tensor([n], dtype=dtype,
                                                   device=cuda))
            assert int(got) == zlib.adler32(data[:n].tobytes()), (n, dtype)
    # the kernel clamps a length on the card to [0, len(data)]
    assert int(CK.adler32_torch(x, torch.tensor(10 ** 9, device=cuda))) \
        == zlib.adler32(data.tobytes())
    assert int(CK.adler32_torch(x, torch.tensor(-5, device=cuda))) == 1
    with pytest.raises(ValueError):
        CK.adler32_torch(x, 200_001)
    with pytest.raises(TypeError):
        CK.adler32_torch(x, torch.tensor(5.0, device=cuda))


@pytest.mark.cuda
def test_adler32_kernel_queues_without_waiting(cuda):
    """Two calls (an int length and one on the card) queue behind a spin
    kernel: the host returns while the spin still runs, under sync debug
    mode "error", and the results are right once it ends."""
    data = case_data("random", 4 * MIB)
    x = torch.from_numpy(data).to(cuda)
    n_card = torch.tensor(4 * MIB - 3, device=cuda)
    CK.adler32_torch(x, 5)                      # build and bind
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(200_000_000)          # about 0.1 s
        got = [CK.adler32_torch(x, 4 * MIB), CK.adler32_torch(x, n_card)]
        done = torch.cuda.Event()
        done.record()
        assert not done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert [int(g) for g in got] == [zlib.adler32(data.tobytes()),
                                     zlib.adler32(data[:-3].tobytes())]


@pytest.mark.cuda
def test_adler32_kernel_one_launch_no_copy(cuda):
    """Under the profiler a call is one kernel on the card: no copy from
    the host, no memset."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.from_numpy(case_data("random", 4 * MIB)).to(cuda)
    CK.adler32_torch(x, 4 * MIB)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        CK.adler32_torch(x, 4 * MIB)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("adler32_kernel" in n for n in names) == 1, names
    assert not any("Memcpy" in n or "Memset" in n for n in names), names


@pytest.mark.cuda
def test_adler32_launches_on_its_callers_paths(cuda):
    """One launch a group in decompress_indexed with an expected Adler-32
    and none without; one a shard in a single-rank compress_distributed."""
    from deflate_compression_tpu_torch.parallel.dist import (
        compress_distributed)
    raw = corpus.build_corpus(300_000)
    z = zlib.compress(raw, 6)
    idx = tidx.build_index(z[2:-4], prefer_native=False)
    before = [AD.adler32.launches, BT.build_tables.launches]
    assert tidx.decompress_indexed(z[2:-4], idx, shard_out=1 << 16,
                                   expected_adler=zlib.adler32(raw),
                                   device="cuda") == raw
    groups = BT.build_tables.launches - before[1]
    assert groups >= 2
    assert AD.adler32.launches - before[0] == groups
    before = AD.adler32.launches
    assert tidx.decompress_indexed(z[2:-4], idx, shard_out=1 << 16,
                                   device="cuda") == raw
    assert AD.adler32.launches == before
    blob = compress_distributed(raw, shard_size=1 << 16, device="cuda")
    assert zlib.decompress(blob) == raw
    assert AD.adler32.launches - before == -(-len(raw) // (1 << 16))
