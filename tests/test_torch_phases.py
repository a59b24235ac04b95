"""Port parity: the plain versions of the decoder's two phase kernels,
`build_tables_ref` (phase A, ops/build_tables.py) and `resolve_bytes_ref`
(phase C's bytes, ops/copy_sources.py), against the JAX decoder
(decode/tpu_inflate.py) on the CPU and against host references.

The same stream words and index, made from seeded in-repo inputs, go
through both decoders. Tolerance: exact. `ok` and `bad_lanes` are always
identical; the output bytes are identical wherever the decode is ok (on a
stream flagged bad, neither decoder defines its bytes). The CUDA kernels
are held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.decode import tpu_inflate as TI
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.core.bits import BitReader
from deflate_compression_tpu_torch.core.huffman import canonical_codes_np
from deflate_compression_tpu_torch.decode import device_inflate as DI
from deflate_compression_tpu_torch.decode import index as tidx
from deflate_compression_tpu_torch.decode.inflate import _read_dynamic_tables
from deflate_compression_tpu_torch.format import constants as C
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.ops import build_tables as BT
from deflate_compression_tpu_torch.ops import copy_sources as CS
from deflate_compression_tpu_torch.ops import decode_symbols as DS
from test_torch_cuda import first_symbol_16_words, long_run_case

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

S = 1 << 16
W = C.WINDOW_SIZE


# ------------------------------------------------------------------ inputs

def _skewed(n, seed=9):
    """Skewed bytes that drive zlib's trees to deep (up to 15-bit) codes."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefgh" * 4 + b"\x00" * 200, np.uint8)
    return rng.choice(alphabet, n).tobytes()


def _words_of(body: bytes) -> np.ndarray:
    return np.frombuffer(body + bytes(-len(body) % 4 + 4), "<u4").astype(
        np.int64)


def _from_index(raw: bytes, body: bytes, idx) -> dict:
    """decode_blocks arguments (numpy) of a whole raw DEFLATE stream."""
    return dict(raw=raw, words=_words_of(body), blk_bit=idx.bit_base,
                blk_out=idx.out_start, btype=idx.btype.astype(np.int64),
                n_blocks=idx.n_blocks, sub_bit=idx.sub_bit,
                sub_out=idx.sub_out, sub_blk=idx.sub_blk.astype(np.int64),
                n_subs=idx.n_subs, valid=idx.out_len,
                size=max(idx.out_len, 1))


def _case(kind: str) -> dict:
    """A stream and its index: the encoder's own shard ("encoder": dynamic
    blocks; "fixed" and "stored": forced block types; "mixed": dynamic and
    stored blocks), zlib level 9 on skewed bytes ("zlib9": codes up to 15
    bits), or zlib with small blocks on text ("blocks": many blocks whose
    matches cross them)."""
    if kind in ("encoder", "fixed", "stored", "mixed", "zeros"):
        size = S
        data = corpus.sample("zeros" if kind == "zeros" else "text", size,
                             seed=2)
        if kind == "mixed":          # incompressible bytes: stored blocks
            data[size // 2:] = corpus.sample("random", size // 2, seed=2)
        force = {"fixed": C.BTYPE_FIXED, "stored": C.BTYPE_STORED}.get(kind)
        r = {k: v.numpy() for k, v in td.encode_shard(
            torch.from_numpy(data), size, True, force_btype=force).items()}
        return dict(raw=data.tobytes(), words=r["words"],
                    blk_bit=r["block_bit_base"], blk_out=r["block_out_start"],
                    btype=r["btype"], n_blocks=int(r["n_blocks"]),
                    sub_bit=r["sub_bit"], sub_out=r["sub_out"],
                    sub_blk=r["sub_blk"], n_subs=len(r["sub_bit"]),
                    valid=size, size=size)
    if kind == "zlib9":
        raw = _skewed(150_000)
        body = zlib.compress(raw, 9)[2:-4]
    else:
        raw = corpus.sample("text", 90_000).tobytes()
        co = zlib.compressobj(6, zlib.DEFLATED, -15, 3)
        body = co.compress(raw) + co.flush()
    return _from_index(raw, body, tidx.build_index(body, prefer_native=False))


ARGS = ("blk_bit", "blk_out", "btype", "n_blocks", "sub_bit", "sub_out",
        "sub_blk", "n_subs", "valid")


def _jax(c: dict, words=None, **kw) -> dict:
    def i32(x):
        return jnp.asarray(np.asarray(x).astype(np.int32))
    w = c["words"] if words is None else words
    res = TI.decode_blocks(jnp.asarray(np.asarray(w).astype(np.uint32)),
                           *(i32(c[k]) for k in ARGS), c["size"], **kw)
    return {k: np.asarray(v) for k, v in res.items()}


def _plan(c: dict, words=None) -> DI.Plan:
    w = c["words"] if words is None else words
    return DI.plan(torch.from_numpy(np.asarray(w).astype(np.int64)),
                   *(c[k] for k in ARGS))


def _port(c: dict, words=None, prefix=None, prefix_len=None):
    """The port's decode with its seams open: phase A's result, phase C's
    bytes and flags from the plain versions called directly, and the
    verdict as phase_c forms it."""
    p = _plan(c, words)
    b = DI.phase_b(p, c["size"], W)
    v, bad_dist, unconverged = CS.resolve_bytes_ref(
        p.w, b.tok, p.blk_bit, p.blk_out, p.blk_end, p.a.blive, p.a.is_sto,
        c["size"], prefix, prefix_len)
    bad_lanes = p.ln.llive & (b.bad | ~b.done)
    ok = not (bool(bad_lanes.any()) or bool((p.a.bbad & p.a.blive).any())
              or bool(bad_dist) or bool(unconverged))
    full = DI.phase_c(p, b, c["size"], prefix, prefix_len)
    assert bool(full["ok"]) == ok
    assert torch.equal(full["out"][:c["valid"]], v[:c["valid"]])
    return p, dict(out=v.numpy(), ok=ok, bad_lanes=bad_lanes.numpy(),
                   bad_dist=bool(bad_dist))


def _same(got: dict, want: dict, valid: int) -> None:
    assert got["ok"] == bool(want["ok"])
    np.testing.assert_array_equal(got["bad_lanes"], want["bad_lanes"])
    if got["ok"]:
        np.testing.assert_array_equal(got["out"][:valid], want["out"][:valid])


# ----------------------------------------------------------------- phase A

@pytest.mark.parametrize("kind", ["encoder", "zlib9", "fixed", "stored",
                                  "mixed", "blocks"])
def test_build_tables_ref_decode_matches_jax(kind):
    """Phase A's plain version on clean streams: no block bad, the block
    classes as the index says, and the decode built on its tables equal to
    the JAX decoder's and to the input."""
    c = _case(kind)
    p, got = _port(c)
    a = p.a
    n = c["n_blocks"]
    bt = torch.from_numpy(np.asarray(c["btype"]))[:n]
    assert not bool(a.bbad.any()) and bool(a.blive[:n].all())
    assert not bool(a.blive[n:].any())
    assert torch.equal(a.is_sto[:n], bt == 0)
    assert torch.equal(a.huff[:n], (bt == 1) | (bt == 2))
    _same(got, _jax(c), c["valid"])
    assert got["ok"]
    assert got["out"][:c["valid"]].tobytes() == c["raw"]
    want = {"fixed": {1}, "stored": {0}}.get(kind)
    if want:
        assert set(bt.tolist()) == want
    if kind == "mixed":
        assert {0, 2} <= set(bt.tolist())
    if kind == "zlib9":
        assert bool((a.tables.ll_lut == DS.LONG_CODE).any())


def _lengths_from_tables(cnt, order):
    """Code lengths per symbol from the count of codes per length and the
    symbols in canonical order."""
    lens = np.zeros(len(order), np.int64)
    k = 0
    for ln in range(1, DS.MAX_BITS + 1):
        lens[order[k:k + cnt[ln]]] = ln
        k += cnt[ln]
    return lens


def _rev(code: int, n: int) -> int:
    return int(format(code, f"0{n}b")[::-1], 2) if n else 0


@pytest.mark.parametrize("kind", ["encoder", "zlib9", "fixed", "blocks"])
def test_build_tables_ref_luts_decode_every_code(kind):
    """In every Huffman block the tables resolve each symbol's canonical
    code (canonical_codes_np of the block's lengths, bit-reversed, under
    any following bits) to that symbol's payload and length, through the
    11-bit LUT or the long-code walk; a dynamic block's lengths are those
    the host inflater reads from the header."""
    c = _case(kind)
    a = _plan(c).a
    t = a.tables
    body = np.asarray(c["words"]).astype("<u4").tobytes()
    rng = np.random.default_rng(0)
    blocks = np.flatnonzero(a.huff.numpy())
    assert len(blocks)
    for b in blocks[:: max(1, len(blocks) // 12)]:
        for lut, cnt, order, pay, shift, n_host in (
                (t.ll_lut, t.ll_cnt, t.ll_sym, DS.LL_PAY, DS.LL_SHIFT, 0),
                (t.d_lut, t.d_cnt, t.d_sym, DS.D_PAY, DS.D_SHIFT, 1)):
            lens = _lengths_from_tables(cnt[b].numpy(), order[b].numpy())
            if int(c["btype"][b]) == C.BTYPE_DYNAMIC:
                r = BitReader(body, int(c["blk_bit"][b]) + 3)
                sym_lut, len_lut = _read_dynamic_tables(r)[n_host]
                assert r.pos == int(a.hdr_end[b])
            else:
                sym_lut = len_lut = None
                fixed = (C.FIXED_LITLEN_LENGTHS, C.FIXED_DIST_LENGTHS)[n_host]
                np.testing.assert_array_equal(lens[:len(fixed)], fixed)
            codes = canonical_codes_np(lens, DS.MAX_BITS)
            present = np.flatnonzero(lens)
            rc = np.array([_rev(int(codes[s]), int(lens[s]))
                           for s in present])
            if len_lut is not None:
                np.testing.assert_array_equal(len_lut[rc], lens[present])
                np.testing.assert_array_equal(sym_lut[rc], present)
            above = rng.integers(0, 1 << 15, len(present)) << lens[present]
            bits = torch.from_numpy((rc | above) & 0x7FFF)
            e = DS._lookup(lut, cnt, order, torch.as_tensor(pay),
                           torch.full_like(bits, int(b)), bits, shift).numpy()
            np.testing.assert_array_equal(
                e, pay[present] | (lens[present] << shift))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_header_bit_flips_match_jax(seed):
    """Seeded bit flips inside dynamic block headers (the fields, the
    code-length lengths, the RLE stream): the blocks phase A flags bad
    clear `ok` in both decoders, and ok, bad_lanes and bytes equal the JAX
    decoder's."""
    c = _case("blocks" if seed % 2 else "encoder")
    clean = _plan(c).a
    rng = np.random.default_rng(seed)
    dyn = np.flatnonzero(np.asarray(c["btype"])[:c["n_blocks"]] == 2)
    w = np.asarray(c["words"]).copy()
    for _ in range(int(rng.integers(1, 4))):
        b = int(rng.choice(dyn))
        span = int(clean.hdr_end[b]) - int(c["blk_bit"][b])
        bit = int(c["blk_bit"][b]) + 3 + int(rng.integers(0, span - 3))
        w[bit >> 5] ^= 1 << (bit & 31)
    p, got = _port(c, w)
    want = _jax(c, w)
    _same(got, want, c["valid"])
    if bool(p.a.bbad.any()):
        assert not got["ok"] and not bool(want["ok"])
    if got["ok"]:
        assert got["out"][:c["valid"]].tobytes() != c["raw"]


def test_header_bit_flips_flag_blocks_bad():
    """Over the seeds of the test above, phase A itself flags blocks (the
    flips do not all surface only in the lanes)."""
    c = _case("encoder")
    clean = _plan(c).a
    b = int(np.flatnonzero(np.asarray(c["btype"]) == 2)[0])
    n_bad = 0
    for k in range(3, int(clean.hdr_end[b]) - int(c["blk_bit"][b]), 7):
        w = np.asarray(c["words"]).copy()
        bit = int(c["blk_bit"][b]) + k
        w[bit >> 5] ^= 1 << (bit & 31)
        n_bad += bool(_plan(c, w).a.bbad[b])
    assert n_bad >= 3


def test_repeat_without_previous_length_matches_jax():
    """A dynamic header whose first code-length symbol is 16 (repeat the
    previous length, and there is none): bad in both decoders, and the
    plain version builds the tables of absent lengths."""
    words = np.concatenate([first_symbol_16_words(), np.zeros(14, "<u4")])
    c = dict(words=words.astype(np.int64), blk_bit=[0],
             blk_out=[0], btype=[2], n_blocks=1, sub_bit=[-1], sub_out=[0],
             sub_blk=[0], n_subs=1, valid=16, size=16)
    p, got = _port(c)
    assert bool(p.a.bbad[0]) and int(p.a.hdr_end[0]) == 32
    assert int(p.a.tables.ll_cnt.sum()) == 0
    assert int(p.a.tables.ll_lut.abs().sum()) == 0
    assert torch.equal(p.a.tables.ll_sym[0], torch.arange(DS.N_LL).int())
    _same(got, _jax(c), 16)
    assert not got["ok"]


# ----------------------------------------------------------------- phase C

def _group(c: dict, first: int) -> tuple:
    """The blocks from `first` on as one decode group behind a prefix, as
    decompress_indexed forms it: (case, prefix u8[W], prefix_len)."""
    start = int(c["blk_out"][first])
    plen = min(start, W)
    raw = c["raw"]
    prefix = np.zeros(W, np.uint8)
    prefix[:plen] = np.frombuffer(raw[start - plen:start], np.uint8)
    body = np.asarray(c["words"]).astype("<u4").tobytes()
    byte0 = int(c["blk_bit"][first]) // 8 // 4 * 4
    si = int(np.searchsorted(c["sub_blk"], first))
    span = c["valid"] - start
    g = dict(raw=raw[start:], words=_words_of(body[byte0:]),
             blk_bit=c["blk_bit"][first:] - 8 * byte0,
             blk_out=c["blk_out"][first:] - start + plen,
             btype=c["btype"][first:], n_blocks=c["n_blocks"] - first,
             sub_bit=c["sub_bit"][si:] - 8 * byte0,
             sub_out=c["sub_out"][si:] - start + plen,
             sub_blk=c["sub_blk"][si:] - first, n_subs=c["n_subs"] - si,
             valid=plen + span, size=plen + span)
    return g, prefix, plen


def _match_first_words() -> np.ndarray:
    """A fixed block whose first token is a match of length 3, distance 1:
    its source lies before the output start."""
    bits, n = 0, 0
    for value, nbits in ((1, 1), (1, 2), (_rev(1, 7), 7), (0, 5), (0, 7)):
        bits |= value << n
        n += nbits
    return np.frombuffer(bits.to_bytes(64, "little"), "<u4").astype(np.int64)


@pytest.mark.parametrize("case", ["no_prefix", "prefix", "short_prefix",
                                  "stored", "zero_run", "bad_dist"])
def test_resolve_bytes_ref_matches_jax(case):
    """Phase C's plain version, called directly on the port's tokens,
    against the JAX decoder's bytes and ok: without and with a prefix that
    matches reach into, with stored blocks, with a same-distance run longer
    than a tile of the kernel, and with a distance before the output
    start."""
    kw = {}
    if case in ("prefix", "short_prefix"):
        whole = _case("blocks")
        first = {"prefix": whole["n_blocks"] // 2, "short_prefix": 2}[case]
        c, prefix, plen = _group(whole, first)
        assert (plen == W) == (case == "prefix")
        kw = dict(prefix=torch.from_numpy(prefix), prefix_len=plen)
        jkw = dict(prefix=jnp.asarray(prefix), prefix_len=jnp.int32(plen))
    elif case == "bad_dist":
        c = dict(raw=b"", words=_match_first_words(), blk_bit=[0],
                 blk_out=[0], btype=[1], n_blocks=1, sub_bit=[-1],
                 sub_out=[0], sub_blk=[0], n_subs=1, valid=3, size=8)
        jkw = {}
    else:
        c = _case({"no_prefix": "encoder", "stored": "mixed",
                   "zero_run": "zeros"}[case])
        jkw = {}
    p, got = _port(c, **kw)
    want = _jax(c, **jkw)
    _same(got, want, c["valid"])
    assert got["bad_dist"] == (case == "bad_dist")
    assert got["ok"] == (case != "bad_dist")
    if got["ok"]:
        plen = kw.get("prefix_len", 0)
        assert got["out"][plen:c["valid"]].tobytes() == c["raw"]
    if case == "stored":
        assert bool(p.a.is_sto.any()) and bool(p.a.huff.any())
    if case == "zero_run":
        t = DI.phase_b(p, c["size"], W).tok[:c["size"]].long()
        run = ((t >> 26) & 1 == 1) & ((t >> 9) & 0xFFFF == 1)
        assert int(run.sum()) * 258 > 3 * CS.TILE     # one run, many tiles
    if case == "prefix":
        # matches do reach into the prefix: another prefix, other bytes
        other = torch.from_numpy(np.roll(np.asarray(kw["prefix"]), 1))
        _, moved = _port(c, prefix=other, prefix_len=kw["prefix_len"])
        assert moved["out"][W:].tobytes() != got["out"][W:].tobytes()


@pytest.mark.parametrize("bad", [False, True])
def test_resolve_bytes_ref_long_run_of_hand_made_tokens(bad):
    """One run of distance 1 over seven tiles resolves in one round; a
    first match before the output start raises bad_dist."""
    args, S_ = long_run_case(bad)
    stats = {}
    v, bad_dist, unconverged = CS.resolve_bytes_ref(*args, S_, stats=stats)
    assert bool(bad_dist) == bad and not bool(unconverged)
    assert len(stats["tagged"]) == 1 and stats["stored_bytes"] == 0
    assert v.tolist() == [0 if bad else 65] * S_
    assert CS.max_rounds(S_) == 16


def test_phase_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors both wrappers are their plain versions and launch
    nothing; malformed arguments raise."""
    c = _case("encoder")
    p = _plan(c)
    bt = torch.from_numpy(np.asarray(c["btype"]))
    before = BT.build_tables.launches, CS.resolve_bytes.launches
    a = BT.build_tables(p.w, p.blk_bit, bt, c["n_blocks"])
    for g, x in zip(a.tables, p.a.tables):
        assert torch.equal(g, x)
    tok = DI.phase_b(p, S, W).tok
    args = (p.w, tok, p.blk_bit, p.blk_out, p.blk_end, a.blive, a.is_sto)
    v, _, _ = CS.resolve_bytes(*args, S)
    assert v.numpy().tobytes() == c["raw"]
    assert (BT.build_tables.launches, CS.resolve_bytes.launches) == before
    with pytest.raises(TypeError):
        BT.build_tables(p.w.int(), p.blk_bit, bt, c["n_blocks"])
    with pytest.raises(ValueError):
        BT.build_tables(p.w, p.blk_bit[:-1], bt, c["n_blocks"])
    with pytest.raises(TypeError):
        CS.resolve_bytes(p.w, tok.long(), *args[2:], S)
    with pytest.raises(ValueError):
        CS.resolve_bytes(*args[:-1], a.is_sto.int(), S)


def test_valid_out_defaults_to_out_size_and_accepts_a_tensor():
    """resolve_bytes_ref's valid_out: absent is out_size; an int and a
    0-dim int64 cut the same bytes."""
    c = _case("encoder")
    p = _plan(c)
    tok = DI.phase_b(p, S, W).tok
    args = (p.w, tok, p.blk_bit, p.blk_out, p.blk_end, p.a.blive, p.a.is_sto)
    whole = CS.resolve_bytes_ref(*args, S)[0]
    assert torch.equal(CS.resolve_bytes_ref(*args, S, valid_out=S)[0], whole)
    cut = S // 3 + 5
    by_int = CS.resolve_bytes_ref(*args, S, valid_out=cut)[0]
    by_tensor = CS.resolve_bytes(*args, S, valid_out=torch.tensor(cut))[0]
    assert torch.equal(by_int, by_tensor)
    assert torch.equal(by_int[:cut], whole[:cut]) and not by_int[cut:].any()


@pytest.mark.parametrize("kind", ["encoder", "zlib9", "mixed", "blocks"])
def test_valid_out_below_out_size_matches_jax(kind):
    """An output capacity past the decoded bytes: phase_c's output (the
    zero tail now cut by resolve_bytes_ref's valid_out) equals the JAX
    decoder's whole output, and a valid_out cut inside the bytes keeps
    exactly the bytes below it."""
    c = dict(_case(kind))
    c["size"] = c["valid"] + 3 * CS.TILE + 7
    p = _plan(c)
    b = DI.phase_b(p, c["size"], W)
    full = DI.phase_c(p, b, c["size"])
    want = _jax(c)
    assert bool(full["ok"]) and bool(want["ok"])
    np.testing.assert_array_equal(full["out"].numpy(), want["out"])
    assert full["out"][:c["valid"]].numpy().tobytes() == c["raw"]
    assert not full["out"][c["valid"]:].any()
    args = (p.w, b.tok, p.blk_bit, p.blk_out, p.blk_end, p.a.blive,
            p.a.is_sto)
    cut = c["valid"] // 2 + 1
    v, bad_dist, unconverged = CS.resolve_bytes_ref(*args, c["size"],
                                                    valid_out=cut)
    assert not bool(bad_dist) and not bool(unconverged)
    assert v.numpy()[:cut].tobytes() == c["raw"][:cut]
    assert not v[cut:].any()


# ------------------------------------- the kernel's code-length walk, modelled
#
# csrc/build_tables.cu walks a dynamic header's code-length stream in
# parallel: the symbol at every bit offset a walk can reach, the path of
# offsets from the first RLE bit, a scan of the repeat counts (each step's
# place), a scan of the last fill that is not a 16 (each step's previous
# length), the first bad step, and the lengths each step covers. This numpy
# model follows those steps and is held field for field against the plain
# version, which walks step by step.

SPAN = 7 * BT.RLE_STEPS           # the bit offsets the kernel decodes


def _peek(words: np.ndarray, bp: int) -> int:
    n = len(words)
    wi = min(max(bp >> 5, 0), n - 1)
    wj = min(wi + 1, n - 1)
    sh = bp & 31
    lo, hi = int(words[wi]) & 0xFFFFFFFF, int(words[wj]) & 0xFFFFFFFF
    return ((lo >> sh) | (hi << (32 - sh))) & 0xFFFFFFFF


def walk_model(words: np.ndarray, bit: int) -> dict:
    """A dynamic block's header as the kernel reads it: hlit, hdist, the
    316 lengths, the bit after the header and whether the header is bad
    (before the Kraft check of the two trees)."""
    bp0 = bit + 3
    hw = _peek(words, bp0)
    hlit, hdist = (hw & 31) + 257, ((hw >> 5) & 31) + 1
    hclen = ((hw >> 10) & 15) + 4
    rle = 14 + 3 * hclen
    clen = np.zeros(C.NUM_CLEN, np.int64)
    for j in range(hclen):
        clen[C.CLEN_ORDER[j]] = _peek(words, bp0 + 14 + 3 * j) & 7
    count = np.bincount(clen, minlength=8)
    kraft = sum(int(count[ln]) << (7 - ln) for ln in range(1, 8))
    codes = canonical_codes_np(clen, 7)
    lut = np.zeros(128, np.int64)
    for j in np.flatnonzero(clen):
        rc = _rev(int(codes[j]), int(clen[j]))
        hit = (np.arange(128) & ((1 << int(clen[j])) - 1)) == rc
        lut[hit] += j | (int(clen[j]) << 5)
    lens = np.zeros(BT.RLE_W, np.int64)
    if hlit > 286 or hdist > 30 or kraft > 128:
        return dict(hlit=hlit, hdist=hdist, lens=lens, end=bp0 + rle,
                    bad=True)
    # the symbol at every offset: next offset, repeat count, symbol
    nxt = np.zeros(SPAN, np.int64)
    rep = np.zeros(SPAN, np.int64)
    sym = np.zeros(SPAN, np.int64)
    for o in range(SPAN):
        lo = _peek(words, bp0 + rle + o)
        e = int(lut[lo & 127])
        cl, s = e >> 5, e & 31
        eb = {16: 2, 17: 3, 18: 7}.get(s, 0)
        ev = (lo >> cl) & ((1 << eb) - 1)
        nxt[o] = o + cl + eb
        rep[o] = 1 if s < 16 else 3 + ev if s <= 17 else 11 + ev
        sym[o] = s
    # the path from the first RLE bit
    total = hlit + hdist
    path, o, i = [], 0, 0
    while len(path) < BT.RLE_STEPS:
        path.append(o)
        i += int(rep[o])
        if i >= total or nxt[o] == o:
            break
        o = int(nxt[o])
    at = np.array(path)
    k = np.arange(len(at))
    r, s, nx = rep[at], sym[at], nxt[at]
    i_end = np.cumsum(r)
    key = np.where(s == 16, -1, (k << 5) | np.where(s < 16, s, 0))
    prev_key = np.concatenate([[-1], np.maximum.accumulate(key)[:-1]])
    prev = np.where(prev_key < 0, -1, prev_key & 31)
    fill = np.where(s < 16, s, np.where(s == 16, prev, 0))
    budget = 32 * len(words) - bp0
    bad = ((nx == at) | ((s == 16) & (prev < 0)) | (i_end > total)
           | (rle + nx > budget))
    first_bad = int(np.argmax(bad)) if bad.any() else len(at)
    last = min(first_bad, len(at) - 1)
    step = np.searchsorted(i_end[:last + 1], np.arange(BT.RLE_W),
                           side="right")
    cover = step <= last
    lens[cover] = np.maximum(fill[np.minimum(step, last)][cover], 0)
    return dict(hlit=hlit, hdist=hdist, lens=lens,
                end=bp0 + rle + int(nx[last]), bad=first_bad < len(at))


def _kraft_over(lengths: np.ndarray) -> bool:
    return sum(1 << (15 - int(x)) for x in lengths if x) > (1 << 15)


def _walk_cases(kind: str):
    """(words, blk_bit, btype, n_blocks) of one walk case."""
    if kind.startswith("flips"):        # test_header_bit_flips_match_jax's
        seed = int(kind[5:])
        c = _case("blocks" if seed % 2 else "encoder")
        clean = _plan(c).a
        rng = np.random.default_rng(seed)
        dyn = np.flatnonzero(np.asarray(c["btype"])[:c["n_blocks"]] == 2)
        w = np.asarray(c["words"]).copy()
        for _ in range(int(rng.integers(1, 4))):
            b = int(rng.choice(dyn))
            span = int(clean.hdr_end[b]) - int(c["blk_bit"][b])
            bit = int(c["blk_bit"][b]) + 3 + int(rng.integers(0, span - 3))
            w[bit >> 5] ^= 1 << (bit & 31)
        return w, c["blk_bit"], c["btype"], c["n_blocks"]
    if kind == "garbage":
        rng = np.random.default_rng(5)
        w = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.int64)
        bit = rng.integers(0, 32 * 300, 120)
        bit[:10] = rng.integers(32 * 300 - 200, 32 * 300 + 3000, 10)
        bit[10:15] = rng.integers(-3000, 0, 5)
        return w, bit, np.full(120, 2), 120
    if kind == "repeat16":
        words = np.concatenate([first_symbol_16_words(),
                                np.zeros(14, "<u4")]).astype(np.int64)
        return words, np.array([0]), np.array([2]), 1
    c = _case(kind)
    return c["words"], c["blk_bit"], c["btype"], c["n_blocks"]


@pytest.mark.parametrize("kind", ["encoder", "zlib9", "fixed", "stored",
                                  "garbage", "repeat16"]
                         + [f"flips{s}" for s in range(8)])
def test_walk_model_matches_build_tables_ref(kind):
    """The kernel's parallel code-length walk, modelled in numpy, gives the
    plain version's lengths (read back from its canonical tables), header
    end and bad flag on every block: clean streams of every block type,
    garbage parsed as headers (some past the end of the words, some before
    its start), the seeded header bit flips, and a repeat with no previous
    length."""
    words, bits, btypes, n = _walk_cases(kind)
    a = BT.build_tables_ref(torch.from_numpy(np.asarray(words, np.int64)),
                            torch.from_numpy(np.asarray(bits, np.int64)),
                            torch.from_numpy(np.asarray(btypes, np.int64)),
                            n)
    t = a.tables
    n_dyn = 0
    for b in range(len(bits)):
        bt = int(btypes[b])
        if not (b < n and bt >= 0):
            assert not bool(a.blive[b])
            continue
        if bt != C.BTYPE_DYNAMIC:
            assert int(a.hdr_end[b]) == int(bits[b]) + 3
            assert bool(a.bbad[b]) == (bt == 3)
            continue
        n_dyn += 1
        m = walk_model(np.asarray(words), int(bits[b]))
        ll = np.where(np.arange(DS.N_LL) < m["hlit"],
                      np.concatenate([m["lens"][:C.NUM_LITLEN],
                                      np.zeros(DS.N_LL - C.NUM_LITLEN,
                                               np.int64)]), 0)
        di = np.minimum(m["hlit"] + np.arange(DS.N_D), BT.RLE_W - 1)
        d = np.where(np.arange(DS.N_D) < m["hdist"], m["lens"][di], 0)
        np.testing.assert_array_equal(
            _lengths_from_tables(t.ll_cnt[b].numpy(), t.ll_sym[b].numpy()),
            ll)
        np.testing.assert_array_equal(
            _lengths_from_tables(t.d_cnt[b].numpy(), t.d_sym[b].numpy()), d)
        assert int(a.hdr_end[b]) == m["end"], b
        assert bool(a.bbad[b]) == (m["bad"] or _kraft_over(ll)
                                   or _kraft_over(d)), b
    assert n_dyn > 0 or kind in ("fixed", "stored")
