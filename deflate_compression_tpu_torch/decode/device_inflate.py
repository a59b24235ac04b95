"""Indexed, sub-block-parallel DEFLATE decoder on one device (counterpart of
deflate_compression_tpu/decode/tpu_inflate.py; renamed, since it runs on a
CUDA card).

The decode index (per-block bit/output offsets and sub-entry lanes) comes
from the encoder or from one host pass over a foreign stream
(decode/index.py). Three phases, as in the JAX decoder:

  Phase A (`phase_a`) — vectorized over coding blocks: the dynamic header,
    the 19 code-length lengths, the RLE loop over code-length symbols, the
    Kraft checks, and per block the phase-B tables (ops/decode_symbols.py
    SymbolTables: 2^11-entry LUTs plus the canonical tables of codes up to
    15 bits). Plain PyTorch.
  Phase B (`phase_b`) — one lane per sub-entry decodes tokens from its start
    bit until its output cursor reaches the next entry. This is the CUDA
    kernel `decode_symbols` (shared-memory LUT gathers) on the card, its
    plain version on the CPU. The JAX decoder's TPU workarounds (256-bit
    peek-row tables, the dense symbol-axis compare, 64-lane padded groups)
    have no counterpart here.
  Phase C (`phase_c`) — output bytes: stored-block slice copies, each
    position's covering-token distance, the same-distance run collapse and
    tagged-value pointer doubling (full rounds; the JAX decoder's
    scatter-free compact tail only dodges TPU scatters). Plain PyTorch.

Strictness is the JAX decoder's: invalid prefixes, litlen symbols >= 286,
dist symbols >= 30, HLIT > 286 / HDIST > 30, oversubscribed trees, a repeat
with no previous length, premature EOB, lane overrun, distances over
`max_dist` or before the output start, and the bit budget all clear `ok`;
every loop is bounded. Positions, bit offsets and stream words are int64
(words hold u32 values, core/u32.py).
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from ..core.bits import reverse_bits
from ..core.huffman import canonical_codes
from ..format import constants as C
from ..ops import decode_symbols as DS
from ..ops.lut_gather import lut_gather

_RLE_W = C.NUM_LITLEN + C.NUM_DIST            # 316 code lengths at most
_RLE_STEPS = _RLE_W + 4                       # the JAX loop's step bound
_RLE_CHECK = 8                                # steps between exit checks
_WSTO = 1 << 16                               # a stored block's byte cap

_FIXED_LL_LEN_FULL = np.zeros(DS.N_LL, np.int64)
_FIXED_LL_LEN_FULL[:len(C.FIXED_LITLEN_LENGTHS)] = C.FIXED_LITLEN_LENGTHS
_FIXED_D_LEN_FULL = np.full(DS.N_D, 5, np.int64)
_FIXED_D_LEN_FULL[:len(C.FIXED_DIST_LENGTHS)] = C.FIXED_DIST_LENGTHS


class PhaseA(typing.NamedTuple):
    tables: DS.SymbolTables
    hdr_end: torch.Tensor        # i64[NB] bit after each block's header
    bbad: torch.Tensor           # bool[NB] block flagged bad
    blive: torch.Tensor          # bool[NB]
    huff: torch.Tensor           # bool[NB] fixed or dynamic
    is_sto: torch.Tensor         # bool[NB]


class Lanes(typing.NamedTuple):
    bp: torch.Tensor             # i64[NL] start bit
    ocur: torch.Tensor           # i64[NL] output cursor
    lane_end: torch.Tensor       # i64[NL]
    lblk: torch.Tensor           # i32[NL] block, -1 for a dead lane
    lbad: torch.Tensor           # bool[NL] bad from the start
    llive: torch.Tensor          # bool[NL]


class Plan(typing.NamedTuple):
    """A decode's inputs on its device, phase A's result and the lanes."""
    w: torch.Tensor              # i64[CW] u32 words
    blk_bit: torch.Tensor
    blk_out: torch.Tensor
    blk_end: torch.Tensor
    valid_out: torch.Tensor
    a: PhaseA
    ln: Lanes


# --------------------------------------------------------------- utilities

def _i64(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(torch.int64)


def _words(comp_words: torch.Tensor) -> torch.Tensor:
    """Stream words as int64 u32 values (from int32 bit patterns or int64)."""
    return comp_words.to(torch.int64) & 0xFFFFFFFF


def _words_i32(w: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> the same bits as int32."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _peek32(w: torch.Tensor, bit_pos: torch.Tensor) -> torch.Tensor:
    """32-bit LSB-first window; word indices clip to the array (the JAX
    decoder's _peek32)."""
    W = w.shape[0]
    wi = (bit_pos >> 5).clamp(0, W - 1)
    sh = bit_pos & 31
    lo = w[wi]
    hi = w[(wi + 1).clamp(max=W - 1)]
    keep = (torch.ones_like(sh) << sh) - 1
    return (lo >> sh) | ((hi & keep) << (32 - sh))


def _canon(lengths: torch.Tensor, max_bits: int):
    """Codes per length (NB, max_bits+1), the Kraft oversubscription flag,
    and each symbol's bit-reversed canonical code (-1 where absent)."""
    lvl = torch.arange(max_bits + 1, device=lengths.device)
    count = ((lengths.unsqueeze(2) == lvl) & (lengths.unsqueeze(2) > 0)).sum(1)
    kraft = (count[:, 1:] << (max_bits - lvl[1:])).sum(1)
    over = kraft > (1 << max_bits)
    codes = canonical_codes(lengths, max_bits)
    rcode = reverse_bits(codes, lengths, max_bits)
    return count, over, torch.where(lengths > 0, rcode, -1)


def _lut(lengths, rcode, pay, lut_bits: int, max_bits: int) -> torch.Tensor:
    """Primary LUT (NB, 2^lut_bits): the sum of the payloads of the codes of
    at most lut_bits bits that prefix each index (the JAX decoder's dense
    compare, tabulated: exactly one code for a prefix-free tree), and
    LONG_CODE where only longer codes share the prefix."""
    NB = lengths.shape[0]
    dev = lengths.device
    size = 1 << lut_bits
    p = torch.arange(size, device=dev)
    brow = torch.arange(NB, device=dev).unsqueeze(1)
    lut = torch.zeros((NB, size), dtype=torch.int64, device=dev)
    for ln in range(1, min(lut_bits, max_bits) + 1):
        sel = lengths == ln
        slots = 1 << ln
        idx = torch.where(sel, brow * slots + rcode, NB * slots)
        t = torch.zeros(NB * slots + 1, dtype=torch.int64, device=dev)
        t.index_add_(0, idx.reshape(-1), torch.where(sel, pay, 0).reshape(-1))
        lut += t[:-1].view(NB, slots)[:, p & (slots - 1)]
    if max_bits > lut_bits:
        sel = lengths > lut_bits
        idx = torch.where(sel, brow * size + (rcode & (size - 1)), NB * size)
        n = torch.zeros(NB * size + 1, dtype=torch.int64, device=dev)
        n.index_add_(0, idx.reshape(-1), sel.long().reshape(-1))
        lut = torch.where((n[:-1].view(NB, size) > 0) & (lut == 0),
                          DS.LONG_CODE, lut)
    return lut.to(torch.int32)


def _tables(lengths, pay_static, shift):
    """LUT, codes per length, canonical symbol order, and the Kraft flag
    of one alphabet for every block."""
    count, over, rcode = _canon(lengths, DS.MAX_BITS)
    n = lengths.shape[1]
    pay = torch.where(lengths > 0,
                      torch.as_tensor(pay_static, device=lengths.device)
                      .long() | (lengths << shift), 0)
    lut = _lut(lengths, rcode, pay, DS.LUT_BITS, DS.MAX_BITS)
    s = torch.arange(n, device=lengths.device)
    key = torch.where(lengths > 0, lengths * 512 + s,
                      (DS.MAX_BITS + 1) * 512 + s)
    order = torch.argsort(key, dim=1).to(torch.int32)
    return lut, count.to(torch.int32).contiguous(), order.contiguous(), over


# ------------------------------------------------------------------ phase A

def phase_a(w: torch.Tensor, blk_bit, blk_btype, n_blocks) -> PhaseA:
    """Block headers and the phase-B tables (tpu_inflate.py:352-454)."""
    dev = w.device
    NB = blk_bit.shape[0]
    bit_budget = 32 * w.shape[0]
    blanes = torch.arange(NB, device=dev)
    blive = (blanes < n_blocks) & (blk_btype >= 0)
    is_dyn = blive & (blk_btype == C.BTYPE_DYNAMIC)
    is_fix = blive & (blk_btype == C.BTYPE_FIXED)
    is_sto = blive & (blk_btype == C.BTYPE_STORED)
    bbad = blive & (blk_btype == 3)                      # reserved BTYPE
    huff = is_dyn | is_fix

    bp = blk_bit + 3                                     # skip BFINAL/BTYPE
    hw = _peek32(w, bp)
    hlit = torch.where(is_dyn, (hw & 31) + 257, 257)
    hdist = torch.where(is_dyn, ((hw >> 5) & 31) + 1, 1)
    hclen = torch.where(is_dyn, ((hw >> 10) & 15) + 4, 4)
    bbad = bbad | (is_dyn & ((hlit > 286) | (hdist > 30)))
    bp = torch.where(is_dyn, bp + 14, bp)

    # the j-th transmitted clen length sits at bp + 3j
    j = torch.arange(C.NUM_CLEN, device=dev)
    v = _peek32(w, bp.unsqueeze(1) + 3 * j) & 7
    use = is_dyn.unsqueeze(1) & (j < hclen.unsqueeze(1))
    clen_lens = torch.zeros((NB, C.NUM_CLEN), dtype=torch.int64, device=dev)
    clen_lens[:, torch.as_tensor(C.CLEN_ORDER, device=dev)] = \
        torch.where(use, v, 0)
    bp = torch.where(is_dyn, bp + 3 * hclen, bp)

    _, cl_over, cl_rc = _canon(clen_lens, C.MAX_CLEN_BITS)
    bbad = bbad | (is_dyn & cl_over)
    cl_pay = torch.where(clen_lens > 0, j | (clen_lens << 5), 0)
    cl_lut = _lut(clen_lens, cl_rc, cl_pay, C.MAX_CLEN_BITS,
                  C.MAX_CLEN_BITS).long()

    # RLE loop over code-length symbols (tpu_inflate.py rle_body): masked
    # steps, so running past a block's end changes nothing
    total = hlit + hdist
    t316 = torch.arange(_RLE_W, device=dev)
    i = torch.zeros(NB, dtype=torch.int64, device=dev)
    prev = torch.full((NB,), -1, dtype=torch.int64, device=dev)
    lens = torch.zeros((NB, _RLE_W), dtype=torch.int64, device=dev)
    bad = bbad
    for step in range(_RLE_STEPS):
        act = is_dyn & (i < total) & ~bad
        if step % _RLE_CHECK == 0 and not bool(act.any()):
            break
        lo = _peek32(w, bp)
        e = cl_lut.gather(1, (lo & 127).unsqueeze(1)).squeeze(1)
        cl = e >> 5
        bad = bad | (act & (cl == 0))
        sym = e & 0x1F
        is_lit = sym < 16
        is16 = sym == 16
        eb = torch.where(is16, 2, torch.where(sym == 17, 3,
                                              torch.where(sym == 18, 7, 0)))
        ev = (lo >> cl) & ((torch.ones_like(eb) << eb) - 1)
        rep = torch.where(is_lit, 1, torch.where(sym <= 17, 3 + ev, 11 + ev))
        fill = torch.where(is_lit, sym, torch.where(is16, prev, 0))
        bad = bad | (act & is16 & (prev < 0))
        cover = ((t316 >= i.unsqueeze(1)) & (t316 < (i + rep).unsqueeze(1))
                 & act.unsqueeze(1))
        lens = torch.where(cover, fill.unsqueeze(1), lens)
        i = torch.where(act, i + rep, i)
        bad = bad | (act & (i > total))
        prev = torch.where(act, fill, prev)
        bp = torch.where(act, bp + cl + eb, bp)
        bad = bad | (act & (bp > bit_budget))
    bbad = bad

    tl = torch.arange(DS.N_LL, device=dev)
    ll_dyn = torch.cat([lens[:, :C.NUM_LITLEN],
                        lens.new_zeros((NB, DS.N_LL - C.NUM_LITLEN))], 1)
    ll_lens = torch.where(tl < hlit.unsqueeze(1), ll_dyn, 0)
    td = torch.arange(DS.N_D, device=dev)
    d_lens = lens.gather(1, (hlit.unsqueeze(1) + td).clamp(0, _RLE_W - 1))
    d_lens = torch.where(td < hdist.unsqueeze(1), d_lens, 0)
    ll_lens = torch.where(is_fix.unsqueeze(1),
                          torch.as_tensor(_FIXED_LL_LEN_FULL, device=dev),
                          ll_lens)
    d_lens = torch.where(is_fix.unsqueeze(1),
                         torch.as_tensor(_FIXED_D_LEN_FULL, device=dev),
                         d_lens)

    ll_lut, ll_cnt, ll_sym, ll_over = _tables(ll_lens, DS.LL_PAY, DS.LL_SHIFT)
    d_lut, d_cnt, d_sym, d_over = _tables(d_lens, DS.D_PAY, DS.D_SHIFT)
    bbad = bbad | (huff & (ll_over | d_over))
    tables = DS.SymbolTables(ll_lut, d_lut, ll_cnt, d_cnt, ll_sym, d_sym)
    return PhaseA(tables, bp, bbad, blive, huff, is_sto)


# ------------------------------------------------------------------ phase B

def block_flags(a: PhaseA) -> torch.Tensor:
    """Per-block lane flags, huff | bad << 1, as an int32 table padded to a
    power of two (the LUT gather's table)."""
    NB = a.bbad.shape[0]
    flags = torch.zeros(1 << max(NB - 1, 0).bit_length(), dtype=torch.int32,
                        device=a.bbad.device)
    flags[:NB] = a.huff.int() | (a.bbad.int() << 1)
    return flags


def lanes(a: PhaseA, sub_bit, sub_out, sub_blk, n_subs, blk_end) -> Lanes:
    """Per-lane start, end and status (tpu_inflate.py:462-470). Each lane
    reads its block's flags (Huffman, bad) by the LUT gather kernel."""
    dev = sub_bit.device
    NB = a.bbad.shape[0]
    NL = sub_bit.shape[0]
    llanes = torch.arange(NL, device=dev)
    lblk = sub_blk.clamp(0, max(NB - 1, 0))
    f = lut_gather(block_flags(a), lblk.to(torch.int32))
    llive = (llanes < n_subs) & (sub_blk >= 0) & ((f & 1) == 1)
    nxt = sub_out[(llanes + 1).clamp(max=max(NL - 1, 0))]
    # a lane ends at the next entry or at its block's end; the last lane
    # has no next entry and ends with its block (no constant sentinel,
    # which a flat batch's offsets could pass)
    lane_end = blk_end[lblk]
    lane_end = torch.where(llanes + 1 < n_subs,
                           torch.minimum(nxt, lane_end), lane_end)
    lbad = llive & ((f & 2) == 2)
    bp = torch.where(sub_bit >= 0, sub_bit, a.hdr_end[lblk])
    return Lanes(bp, sub_out, lane_end,
                 torch.where(llive, lblk, -1).to(torch.int32), lbad, llive)


def phase_b_args(p: Plan, out_size: int, max_dist) -> tuple:
    """The decode_symbols arguments of a plan: every lane's tokens, bounded
    by 4 * out_size + 64 per lane (the JAX decoder's step bound) and by the
    words' bit budget."""
    S = int(out_size)
    return (_words_i32(p.w), p.ln.bp, p.ln.ocur, p.ln.lane_end, p.ln.lblk,
            p.ln.lbad, p.a.tables, int(max_dist), 32 * p.w.shape[0], S,
            4 * S + 64)


def phase_b(p: Plan, out_size: int, max_dist) -> DS.SymbolResult:
    """Token decode of every lane: the decode_symbols kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return DS.decode_symbols(*phase_b_args(p, out_size, max_dist))


# ------------------------------------------------------------------ phase C

def phase_c(p: Plan, b: DS.SymbolResult, out_size: int, prefix=None,
            prefix_len=None) -> dict:
    """Output bytes from the tokens (tpu_inflate.py:600-841), and the
    decode's verdict: dict(out=u8[out_size], ok, bad_lanes)."""
    w, tok, a = p.w, b.tok, p.a
    blk_bit, blk_out, blk_end = p.blk_bit, p.blk_out, p.blk_end
    dev = tok.device
    S = int(out_size)
    NB = blk_bit.shape[0]
    j = torch.arange(S, device=dev)
    t = tok[:S].long()
    t_valid = ((t >> 25) & 1) == 1
    t_match = ((t >> 26) & 1) == 1

    if prefix is not None:
        plen = _i64(prefix_len, dev)
        pref = torch.zeros(S, dtype=torch.int64, device=dev)
        pw = min(prefix.shape[0], S)
        pref[:pw] = prefix[:pw].to(dev).long()
        lit_val = torch.where(j < plen, pref, 0)
    else:
        plen = torch.zeros((), dtype=torch.int64, device=dev)
        lit_val = torch.zeros(S, dtype=torch.int64, device=dev)
    lit_val = torch.where(t_valid & ~t_match, t & 0x1FF, lit_val)

    # live-block coverage and the covering block's stored flag: a packed
    # word scattered at each block start and forward-filled by cummax
    blanes = torch.arange(NB, device=dev)
    ok_start = a.blive & (blk_out >= 0) & (blk_out < S)
    start = torch.where(ok_start, blk_out, S)
    cend = torch.zeros(S + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, start, torch.where(a.blive, blk_end, 0), "amax")[:S]
    pos_live = j < torch.cummax(cend, 0).values
    markv = ((blanes + 1) << 1) | a.is_sto.long()
    pc = torch.zeros(S + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, start, torch.where(a.blive, markv, 0), "amax")[:S]
    pc = torch.cummax(pc, 0).values
    pos_sto = ((pc & 1) == 1) & (j >= plen) & ((pc >> 1) > 0)

    # stored payloads: one contiguous slice copy per live stored block, in
    # block order (later blocks win, as in the JAX fori_loop)
    sto = torch.nonzero(a.is_sto).squeeze(1)
    if sto.numel():
        CW = w.shape[0]
        shifts = torch.arange(0, 32, 8, device=dev)
        cbytes = torch.cat([((w.unsqueeze(1) >> shifts) & 0xFF).reshape(-1),
                            w.new_zeros(_WSTO)])
        lv = torch.cat([lit_val, lit_val.new_zeros(_WSTO)])
        src = (((blk_bit[sto] + 3 + 7) >> 3) + 4).clamp(0, 4 * CW)
        dst = blk_out[sto].clamp(0, S)
        n = (blk_end[sto] - blk_out[sto]).clamp(0, _WSTO)
        for s0, d0, k in zip(src.tolist(), dst.tolist(), n.tolist()):
            lv[d0:d0 + k] = cbytes[s0:s0 + k]
        lit_val = lv[:S]

    # covering token per position; same-distance runs collapse to one step
    s_j = torch.cummax(torch.where(t_valid, j, -1), 0).values
    t_cov = t[s_j.clamp(min=0)]
    d_j = torch.where((s_j >= 0) & (((t_cov >> 26) & 1) == 1),
                      (t_cov >> 9) & 0xFFFF, 0)
    mpos = (d_j > 0) & ~pos_sto & (j >= plen) & pos_live
    rd = torch.where(mpos, d_j, 0)
    prev_rd = torch.cat([rd.new_full((1,), -1), rd[:-1]])
    r = torch.cummax(torch.where(rd != prev_rd, j, -1), 0).values
    base = r - rd
    g = base + torch.where(mpos, (j - base) % rd.clamp(min=1), 0)
    bad_dist = (mpos & (g < 0)).any()

    # tagged-value pointer doubling: v is a resolved byte or TAG | source
    tag_bit = max(24, int(S - 1).bit_length())
    TAG = 1 << tag_bit
    v = torch.where(mpos & (g >= 0), TAG | g.clamp(0, max(S - 1, 0)), lit_val)
    max_rounds = int(np.ceil(np.log2(max(S, 2)))) + 2
    tag = (v & TAG) != 0
    for _ in range(max_rounds):
        if not bool(tag.any()):
            break
        v = torch.where(tag, v[(v & (TAG - 1)).clamp(max=max(S - 1, 0))], v)
        tag = (v & TAG) != 0

    bad_lanes = p.ln.llive & (b.bad | ~b.done)
    out = torch.where(j < p.valid_out, v & 0xFF, 0).to(torch.uint8)
    ok = (~bad_lanes.any() & ~(a.bbad & a.blive).any() & ~bad_dist
          & ~tag.any())
    return {"out": out, "ok": ok, "bad_lanes": bad_lanes}


# -------------------------------------------------------------- entry points

def plan(comp_words, blk_bit, blk_out, blk_btype, n_blocks, sub_bit,
         sub_out, sub_blk, n_subs, valid_out, blk_end=None) -> Plan:
    """Move a decode's index to the words' device, run phase A and set up
    the lanes (arguments as for decode_blocks)."""
    w = _words(comp_words)
    dev = w.device
    blk_bit, blk_out, blk_btype = (_i64(x, dev)
                                   for x in (blk_bit, blk_out, blk_btype))
    sub_bit, sub_out, sub_blk = (_i64(x, dev)
                                 for x in (sub_bit, sub_out, sub_blk))
    n_blocks, n_subs, valid_out = (_i64(x, dev)
                                   for x in (n_blocks, n_subs, valid_out))
    NB = blk_bit.shape[0]
    a = phase_a(w, blk_bit, blk_btype, n_blocks)
    if blk_end is None:
        bl = torch.arange(NB, device=dev)
        nxt = blk_out[(bl + 1).clamp(max=max(NB - 1, 0))]
        blk_end = torch.where(bl + 1 < n_blocks, nxt, valid_out)
        blk_end = torch.where(a.blive, blk_end, blk_out)
    else:
        blk_end = _i64(blk_end, dev)
    ln = lanes(a, sub_bit, sub_out, sub_blk, n_subs, blk_end)
    return Plan(w, blk_bit, blk_out, blk_end, valid_out, a, ln)


def decode_blocks(comp_words, blk_bit, blk_out, blk_btype, n_blocks,
                  sub_bit, sub_out, sub_blk, n_subs, valid_out,
                  out_size: int, prefix=None, prefix_len=None,
                  max_dist=C.WINDOW_SIZE, blk_end=None):
    """Decode a DEFLATE substream given its block index and sub-entries
    (the JAX decoder's decode_blocks, without its unused `lut_bits` and
    its profiling `_ablate`).

    Args:
      comp_words: the substream as LSB-first u32 words (int64 values, or
        int32 bit patterns); its device is the decode's device.
      blk_bit/blk_out/blk_btype: per coding block: bit offset of the 3-bit
        header, output byte offset, BTYPE (-1 for unused slots).
      n_blocks: live block count.
      sub_bit/sub_out/sub_blk: sub-entry lanes: bit offset of the first
        token (-1: the block's first token, after its header), output byte
        offset, owning block (-1: dead lane). Entries are sorted by
        sub_out and each Huffman block's start is its first entry; stored
        blocks need none.
      n_subs: live lane count. valid_out: decoded bytes (prefix included).
      out_size: output capacity (>= valid_out).
      prefix/prefix_len: optional u8 window context occupying output
        [0, prefix_len), so distances may reach into a previous group.
      max_dist: declared window; a longer distance flags the lane bad.
      blk_end: optional per-block output end (default: the next block's
        start, the last block's is valid_out).

    Returns dict(out=u8[out_size], ok=bool tensor, bad_lanes=bool[NL]).
    """
    p = plan(comp_words, blk_bit, blk_out, blk_btype, n_blocks, sub_bit,
             sub_out, sub_blk, n_subs, valid_out, blk_end)
    return phase_c(p, phase_b(p, out_size, max_dist), out_size, prefix,
                   prefix_len)


def flat_batch(comp_words, blk_bit, blk_out, blk_btype, n_blocks, sub_bit,
               sub_out, sub_blk, valid_out, out_size: int) -> dict:
    """decode_blocks arguments of one flat decode of B shards (see
    decode_blocks_batch): the shard id folded into the offsets."""
    w = _words(comp_words)
    dev = w.device
    B, CW = w.shape
    blk_bit, blk_out, blk_btype, sub_bit, sub_out, sub_blk = (
        _i64(x, dev).reshape(B, -1)
        for x in (blk_bit, blk_out, blk_btype, sub_bit, sub_out, sub_blk))
    n_blocks = _i64(n_blocks, dev).reshape(B)
    valid = _i64(valid_out, dev).reshape(B)
    NBs = blk_bit.shape[1]
    S = int(out_size)
    sidx = torch.arange(B, device=dev).unsqueeze(1)

    blive = (torch.arange(NBs, device=dev) < n_blocks.unsqueeze(1)) \
        & (blk_btype >= 0)
    fb = torch.where(blive, blk_bit + sidx * (CW * 32), 0)
    fo = torch.where(blive, blk_out + sidx * S, -1)
    ft = torch.where(blive, blk_btype, -1)
    # a block ends where the next live block of its shard starts (live
    # blocks are a prefix of each row), the last at the shard's valid end
    nxt = torch.cat([blk_out[:, 1:], blk_out.new_zeros((B, 1))], 1)
    lastb = torch.arange(NBs, device=dev) + 1 >= n_blocks.unsqueeze(1)
    fe = torch.where(blive, torch.where(lastb, valid.unsqueeze(1), nxt)
                     + sidx * S, -1)
    slive = sub_blk >= 0
    fsb = torch.where(slive, sub_bit + sidx * (CW * 32), -1)
    # a dead lane's offset is the batch's end, which no live lane passes,
    # so the live lane before it still ends with its block
    fso = torch.where(slive, sub_out + sidx * S, B * S)
    fsk = torch.where(slive, sub_blk + sidx * NBs, -1)
    return dict(comp_words=w.reshape(-1), blk_bit=fb.reshape(-1),
                blk_out=fo.reshape(-1), blk_btype=ft.reshape(-1),
                n_blocks=B * NBs, sub_bit=fsb.reshape(-1),
                sub_out=fso.reshape(-1), sub_blk=fsk.reshape(-1),
                n_subs=fsb.numel(), valid_out=B * S, blk_end=fe.reshape(-1))


def decode_blocks_batch(comp_words, blk_bit, blk_out, blk_btype, n_blocks,
                        sub_bit, sub_out, sub_blk, valid_out,
                        out_size: int, max_dist=C.WINDOW_SIZE):
    """Decode B independent shard substreams in one flat call.

    Every argument has a leading batch dimension B, as the encoder's
    per-shard results stacked: comp_words [B, CW]; blk_* [B, NB] (dead
    slots btype -1); n_blocks [B]; sub_* [B, NL] (dead lanes sub_blk -1);
    valid_out [B] decoded bytes per shard. The shard id is folded into the
    offsets (s*CW*32 bits, s*out_size bytes, s*NB blocks), so one decode
    covers the batch. Returns dict(out=u8[B, out_size], ok, bad_lanes
    [B, NL])."""
    flat = flat_batch(comp_words, blk_bit, blk_out, blk_btype, n_blocks,
                      sub_bit, sub_out, sub_blk, valid_out, out_size)
    B = comp_words.shape[0]
    S = int(out_size)
    r = decode_blocks(**flat, out_size=B * S, max_dist=max_dist)
    dev = r["out"].device
    valid = _i64(valid_out, dev).reshape(B, 1)
    out = torch.where(torch.arange(S, device=dev) < valid,
                      r["out"].reshape(B, S), 0)
    return {"out": out, "ok": r["ok"],
            "bad_lanes": r["bad_lanes"].reshape(B, -1)}


def decode_shard_indexed(comp_words, bit_base, out_start, btype, n_blocks,
                         valid_out, out_size, prefix=None, prefix_len=None):
    """One lane per block (no sub-entries): decode_blocks with each
    Huffman block's start as its only lane."""
    w = _words(comp_words)
    dev = w.device
    btype = _i64(btype, dev)
    out_start = _i64(out_start, dev)
    NB = btype.shape[0]
    lanes_ = torch.arange(NB, device=dev)
    huff = (btype == C.BTYPE_DYNAMIC) | (btype == C.BTYPE_FIXED)
    return decode_blocks(w, bit_base, out_start, btype, n_blocks,
                         torch.full((NB,), -1, dtype=torch.int64,
                                    device=dev),
                         out_start, torch.where(huff, lanes_, -1), n_blocks,
                         valid_out, out_size, prefix=prefix,
                         prefix_len=prefix_len)
