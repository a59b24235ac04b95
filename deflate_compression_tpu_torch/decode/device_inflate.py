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
    15 bits). This is the CUDA kernel `build_tables` on the card, its
    plain version on the CPU (ops/build_tables.py).
  Phase B (`phase_b`) — one lane per sub-entry decodes tokens from its start
    bit until its output cursor reaches the next entry. This is the CUDA
    kernel `decode_symbols` (shared-memory LUT gathers) on the card, its
    plain version on the CPU. The JAX decoder's TPU workarounds (256-bit
    peek-row tables, the dense symbol-axis compare, 64-lane padded groups)
    have no counterpart here.
  Phase C (`phase_c`) — output bytes: stored-block slice copies, each
    position's covering-token distance, the same-distance run collapse and
    tagged-value pointer doubling (full rounds; the JAX decoder's
    scatter-free compact tail only dodges TPU scatters), and the bytes past
    valid_out cleared. The bytes are the CUDA kernels of `copy_sources` on
    the card, their plain version on the CPU (ops/copy_sources.py); the
    verdict is a few tensor operations.

Strictness is the JAX decoder's: invalid prefixes, litlen symbols >= 286,
dist symbols >= 30, HLIT > 286 / HDIST > 30, oversubscribed trees, a repeat
with no previous length, premature EOB, lane overrun, distances over
`max_dist` or before the output start, and the bit budget all clear `ok`;
every loop is bounded. Positions, bit offsets and stream words are int64
(words hold u32 values, core/u32.py).
"""
from __future__ import annotations

import typing

import torch

from ..format import constants as C
from ..ops import build_tables as BT
from ..ops import copy_sources as CS
from ..ops import decode_symbols as DS
from ..ops.lut_gather import lut_gather
from ..utils.logging_util import spanned

PhaseA = BT.PhaseA
_tables = BT._tables


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


# ------------------------------------------------------------------ phase A

@spanned("decode.phase_a")
def phase_a(w: torch.Tensor, blk_bit, blk_btype, n_blocks) -> PhaseA:
    """Block headers and the phase-B tables (tpu_inflate.py:352-454): the
    build_tables kernel on a CUDA tensor, its plain version on a CPU
    tensor."""
    return BT.build_tables(w, blk_bit, blk_btype, n_blocks)


# ------------------------------------------------------------------ phase B

def block_flags(a: PhaseA) -> torch.Tensor:
    """Per-block lane flags, huff | bad << 1, as an int32 table padded to a
    power of two (the LUT gather's table)."""
    NB = a.bbad.shape[0]
    flags = torch.zeros(1 << max(NB - 1, 0).bit_length(), dtype=torch.int32,
                        device=a.bbad.device)
    flags[:NB] = a.huff.int() | (a.bbad.int() << 1)
    return flags


@spanned("decode.lanes")
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


@spanned("decode.phase_b")
def phase_b(p: Plan, out_size: int, max_dist) -> DS.SymbolResult:
    """Token decode of every lane: the decode_symbols kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return DS.decode_symbols(*phase_b_args(p, out_size, max_dist))


# ------------------------------------------------------------------ phase C

@spanned("decode.phase_c")
def phase_c(p: Plan, b: DS.SymbolResult, out_size: int, prefix=None,
            prefix_len=None) -> dict:
    """Output bytes from the tokens (tpu_inflate.py:600-841), resolved by
    the copy_sources kernels on a CUDA tensor and their plain version on a
    CPU tensor, and the decode's verdict: dict(out=u8[out_size], ok,
    bad_lanes)."""
    a = p.a
    out, bad_dist, unconverged = CS.resolve_bytes(
        p.w, b.tok, p.blk_bit, p.blk_out, p.blk_end, a.blive, a.is_sto,
        out_size, prefix, prefix_len, p.valid_out)
    bad_lanes = p.ln.llive & (b.bad | ~b.done)
    ok = (~bad_lanes.any() & ~(a.bbad & a.blive).any() & ~bad_dist
          & ~unconverged)
    return {"out": out, "ok": ok, "bad_lanes": bad_lanes}


# -------------------------------------------------------------- entry points

@spanned("decode.plan")
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


@spanned("decode.blocks")
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


@spanned("decode.flat_batch")
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


@spanned("decode.batch")
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
