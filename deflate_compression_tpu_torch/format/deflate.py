"""DEFLATE shard encoder: tokens -> RFC 1951 bitstream (counterpart of
deflate_compression_tpu/format/deflate.py).

One shard (S bytes, S % 32768 == 0) is tokenized once (core/lz77.py),
cut into NB = S / 32768 tiles, planned into coding blocks (core/cost.py:
ops/block_plan.py), given per-block length-limited Huffman tables
(ops/huffman_codes.py), and its header items built here. ops/pack_words.py
then serializes it: the token items, the block layout (stored-block byte
alignment, a log-depth scan), the item offsets and the stored payloads,
packed into LSB-first u32 words, and the sub-block decode entries, in
one pass of one kernel on the card. A non-final shard ends with an empty
stored block, so shard substreams concatenate.

The output is bit-identical to the JAX encoder's for the same input and
options as the JAX codec runs it, under jax.jit (`encode_shard_jit`),
the block split included. Called eagerly, the JAX block plan's float32
DP can round a near-tie the other way (`corpus.block_plan_case
("m32_short")`, a margin of 0.375 bits): a property of the eager call, not
of the port, so the tests hold the port against the jitted function. u32
values are carried in int64 tensors (core/u32.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import bits as bits_mod
from ..core import huffman, lz77
from ..core.cost import block_plan
from ..core import scans
from ..device import pick_device
from ..utils.logging_util import span, spanned
from ..ops.huffman_codes import huffman_codes
from ..ops.pack_words import (BLOCK, H_ITEMS as _H_ITEMS, RLE_SLOTS as
                              _RLE_SLOTS, SLOT_EOB as _SLOT_EOB,
                              SLOT_LENNLEN as _SLOT_LENNLEN, dist_fields,
                              len_fields, pack_words)
from . import constants as C

TREE_LIMIT = 11                  # emitted Huffman code-length cap
MAX_MERGE = 8                    # most tiles merged into one coding block


def _reversed_codes(lengths: np.ndarray) -> np.ndarray:
    """Each canonical code of `lengths` bit-reversed within its length."""
    codes = huffman.canonical_codes_np(lengths, 15)
    return np.array([int(format(int(c), f"0{l}b")[::-1], 2) if l else 0
                     for c, l in zip(codes, lengths)], np.int64)


_FIXED_LL_LEN = C.FIXED_LITLEN_LENGTHS[:C.NUM_LITLEN]
_FIXED_LL_REV = _reversed_codes(C.FIXED_LITLEN_LENGTHS)[:C.NUM_LITLEN]
_FIXED_D_LEN = C.FIXED_DIST_LENGTHS[:C.NUM_DIST]
_FIXED_D_REV = _reversed_codes(C.FIXED_DIST_LENGTHS)[:C.NUM_DIST]


@functools.cache
def _consts(dev: torch.device) -> dict:
    """The encoder's constant tables as int64 tensors on `dev`, built once
    per device: no host-to-device copy inside a shard's encode."""
    tabs = {"len_extra": C.LENGTH_EXTRA, "dist_extra": C.DIST_EXTRA,
            "fixed_ll_len": _FIXED_LL_LEN, "fixed_ll_rev": _FIXED_LL_REV,
            "fixed_d_len": _FIXED_D_LEN, "fixed_d_rev": _FIXED_D_REV,
            "clen_order": C.CLEN_ORDER}
    return {k: torch.as_tensor(np.asarray(v, np.int64), device=dev)
            for k, v in tabs.items()}


def out_words(shard_size: int) -> int:
    """Worst-case output capacity (u32 words) for a shard."""
    nb = shard_size // BLOCK
    return (nb * (42 + 9 * BLOCK) + 96) // 32


def _force_two_codes(freqs: torch.Tensor) -> torch.Tensor:
    """At least two active symbols per tree (as zlib's build_tree), so
    every transmitted tree is complete. freqs: (NB, n)."""
    cnt = (freqs > 0).sum(dim=1)
    f0 = freqs[:, 0]
    add0 = ((cnt == 0) | ((cnt == 1) & (f0 == 0))).long()
    add1 = ((cnt == 0) | ((cnt == 1) & (f0 > 0))).long()
    out = freqs.clone()
    out[:, 0] += add0
    out[:, 1] += add1
    return out


def _tree_rle(comb: torch.Tensor, total: torch.Tensor):
    """RLE of code-length sequences (RFC 1951 §3.2.7 symbols 0-18).

    comb: (NB, 316) concatenated litlen + dist lengths (-1 past `total`).
    Returns (sym, extra_val, extra_bits), each (NB, 316), sym == -1 where
    nothing is emitted. Each position decides from its run's (value,
    start, length) alone; runs may cross the litlen/dist boundary."""
    NB, W = comb.shape
    dev = comb.device
    t = torch.arange(W, device=dev).unsqueeze(0)
    prev = torch.cat([torch.full((NB, 1), -2, dtype=comb.dtype, device=dev),
                      comb[:, :-1]], dim=1)
    neq = comb != prev                                   # run starts
    rs = scans.cummax_rows(torch.where(neq, t, -1))
    nxt = torch.where(neq, t, W)
    ns = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    ns = torch.cat([ns[:, 1:], torch.full((NB, 1), W, device=dev)], dim=1)
    ne = torch.minimum(ns, total.unsqueeze(1))           # run end (excl.)

    r = ne - rs
    o = t - rs
    v = comb
    valid = (t < total.unsqueeze(1)) & (v >= 0)

    # v != 0
    n_rep = r - 1
    q6 = torch.div(n_rep, 6, rounding_mode="floor")
    m6 = n_rep - 6 * q6
    j = o - 1
    nz_first = o == 0
    nz_full16 = (j >= 0) & (j < 6 * q6) & (j % 6 == 0)
    nz_tail16 = (m6 >= 3) & (j == 6 * q6)
    nz_lit = (m6 < 3) & (j >= 6 * q6) & (j >= 0)
    nz_sym = torch.where(nz_first | nz_lit, v,
                         torch.where(nz_full16 | nz_tail16, 16, -1))
    nz_ebits = torch.where(nz_full16 | nz_tail16, 2, 0)
    nz_eval = torch.where(nz_full16, 6 - 3, torch.where(nz_tail16, m6 - 3, 0))

    # v == 0
    q138 = torch.div(r, 138, rounding_mode="floor")
    m138 = r - 138 * q138
    in_full = o < 138 * q138
    z_full18 = in_full & (o % 138 == 0)
    o2 = o - 138 * q138
    z_tail18 = (~in_full) & (m138 >= 11) & (o2 == 0)
    z_tail17 = (~in_full) & (m138 >= 3) & (m138 < 11) & (o2 == 0)
    z_lit = (~in_full) & (m138 < 3)
    z_sym = torch.where(z_full18 | z_tail18, 18,
                        torch.where(z_tail17, 17, torch.where(z_lit, 0, -1)))
    z_ebits = torch.where(z_full18 | z_tail18, 7, torch.where(z_tail17, 3, 0))
    z_eval = torch.where(z_full18, 138 - 11,
                         torch.where(z_tail18, m138 - 11,
                                     torch.where(z_tail17, m138 - 3, 0)))

    is_zero = v == 0
    sym = torch.where(is_zero, z_sym, nz_sym)
    ebits = torch.where(is_zero, z_ebits, nz_ebits)
    evals = torch.where(is_zero, z_eval, nz_eval)
    sym = torch.where(valid, sym, -1)
    ebits = torch.where(valid & (sym >= 0), ebits, 0)
    evals = torch.where(valid & (sym >= 0), evals, 0)
    return sym, evals, ebits


@spanned("encode.shard")
def encode_shard(data: torch.Tensor, valid_len: int, final: bool,
                 num_candidates: int = 32, lazy: bool = True,
                 force_btype: int | None = None,
                 _test_stride: int | None = None):
    """Encode one shard into a DEFLATE bitstream, on data's device.

    Args:
      data: u8[S] tensor, S a positive multiple of 32768 below 2^30 (the
        sub_out sentinel). Bit offsets are int64; the JAX encoder's int32
        offsets bound the range where the two can agree to about S < 2^27.
      valid_len: number of real bytes, in [1, S].
      final: if True the last block gets BFINAL and no sync flush; if False
        a byte-aligning empty stored block is appended.
      force_btype: None for cost-based selection, or BTYPE_STORED / FIXED /
        DYNAMIC to force every block's type.
      _test_stride: test seam forcing the sub-entry stride.

    Each stage runs in a span "encode.<stage>" inside "encode.shard"
    (utils/logging_util.py), which a running torch profiler records.

    Returns dict: words (int64[OW] holding u32 words), total_bits, and the
    per-block stats and decode index of the JAX encoder.
    """
    S = data.shape[0]
    if data.dim() != 1 or S % BLOCK or S < BLOCK:
        raise ValueError("data must be u8[S] with S a positive multiple "
                         "of 32768")
    valid_len = int(valid_len)
    final = bool(final)
    if not 1 <= valid_len <= S:
        raise ValueError("valid_len must be in [1, S]")
    dev = data.device
    NB = S // BLOCK
    OUT_WORDS = out_words(S)
    i64 = {"dtype": torch.int64, "device": dev}
    K = _consts(dev)

    data = data.to(torch.uint8)
    b_idx = torch.arange(NB, device=dev)
    LB_micro = max((valid_len - 1) // BLOCK, 0)

    # ------------------------------------------------------------- LZ77
    with span("encode.tokenize"):
        tok = lz77.tokenize(data, valid_len, num_candidates=num_candidates,
                            lazy=lazy)
    with span("encode.token_fields"):
        chosen, length, dist = tok["chosen"], tok["length"], tok["dist"]
        is_match = chosen & (length >= C.MIN_MATCH)

        # each position's symbols; masked positions map to the dropped class
        ll_sym_t = torch.where(chosen, torch.where(
            is_match, len_fields(length)[0], data.long()), C.NUM_LITLEN)
        d_sym_t = torch.where(is_match, dist_fields(dist)[0], C.NUM_DIST)

    # --------------------------------------------------- block planning
    with span("encode.tile_histograms"):
        # per-tile histograms (the tile_histogram kernel)
        ll_freq_micro = huffman.histogram_rows(ll_sym_t.view(NB, BLOCK),
                                               C.NUM_LITLEN)
        d_freq_micro = huffman.histogram_rows(d_sym_t.view(NB, BLOCK),
                                              C.NUM_DIST)

    with span("encode.block_plan"):
        if force_btype == C.BTYPE_FIXED and NB > 1:
            # fixed blocks carry no tree: one block
            split = b_idx == 0
        elif force_btype == C.BTYPE_STORED:
            split = torch.ones(NB, dtype=torch.bool, device=dev)
        elif NB > 1:
            tile_bytes = (valid_len - b_idx * BLOCK).clamp(0, BLOCK)
            split, _ = block_plan(ll_freq_micro, d_freq_micro, LB_micro + 1,
                                  tile_bytes, max_merge=MAX_MERGE)
        else:
            split = torch.ones(NB, dtype=torch.bool, device=dev)

    with span("encode.block_histograms"):
        blk_id_micro = torch.cumsum(split.long(), dim=0) - 1
        LB = blk_id_micro[LB_micro]          # last emitted coding block
        b_emitted = b_idx <= LB

        # start/end tile of each coding block (NB buckets, tail unused)
        start_micro = torch.full((NB + 1,), NB, **i64).scatter_reduce(
            0, torch.where(split, blk_id_micro, NB), b_idx, reduce="amin")[:NB]
        end_micro = torch.cat([start_micro[1:],
                               torch.full((1,), NB, **i64)]).clamp(max=NB)
        start_micro_c = start_micro.clamp(max=NB - 1)
        end_micro = torch.maximum(end_micro, start_micro_c + 1)
        n_micros_b = end_micro - start_micro_c
        start_pos_b = start_micro_c * BLOCK
        end_pos_b = (end_micro * BLOCK).clamp(max=S)

        # ------------------------------------------------ histograms / trees
        ll_freq = torch.zeros((NB, C.NUM_LITLEN), **i64).index_add_(
            0, blk_id_micro, ll_freq_micro)
        ll_freq[:, C.EOB] += b_emitted.long()
        d_freq = torch.zeros((NB, C.NUM_DIST), **i64).index_add_(
            0, blk_id_micro, d_freq_micro)
        ll_freq_t = _force_two_codes(ll_freq)
        d_freq_t = _force_two_codes(d_freq)
    with span("encode.huffman_codes"):
        # litlen and zero-padded dist alphabets share one batched build
        d_freq_pad = torch.cat(
            [d_freq_t, torch.zeros((NB, C.NUM_LITLEN - C.NUM_DIST), **i64)], 1)
        both = huffman_codes(torch.cat([ll_freq_t, d_freq_pad], 0), TREE_LIMIT)
        ll_len_dyn = both.lengths[:NB]
        d_len_dyn = both.lengths[NB:, :C.NUM_DIST]
        ll_rev_dyn = both.rev[:NB]
        d_rev_dyn = both.rev[NB:, :C.NUM_DIST]

    # ------------------------------------------ tree description (RLE)
    with span("encode.tree_rle"):
        ar_ll = torch.arange(C.NUM_LITLEN, device=dev)
        ar_d = torch.arange(C.NUM_DIST, device=dev)
        hlit = (torch.where(ll_len_dyn > 0, ar_ll, 0).amax(1)
                + 1).clamp(min=257)
        hdist = (torch.where(d_len_dyn > 0, ar_d, 0).amax(1) + 1).clamp(min=1)
        total_lens = hlit + hdist

        t_idx = torch.arange(_RLE_SLOTS, device=dev).unsqueeze(0)
        in_ll = t_idx < hlit.unsqueeze(1)
        ll_idx = t_idx.clamp(0, C.NUM_LITLEN - 1).expand(NB, _RLE_SLOTS)
        d_idx = (t_idx - hlit.unsqueeze(1)).clamp(0, C.NUM_DIST - 1)
        comb = torch.where(in_ll, torch.gather(ll_len_dyn, 1, ll_idx),
                           torch.gather(d_len_dyn, 1, d_idx))
        comb = torch.where(t_idx < total_lens.unsqueeze(1), comb, -1)

        rle_sym, rle_ev, rle_eb = _tree_rle(comb, total_lens)
        rle_emitted = rle_sym >= 0
        rle_sym_c = rle_sym.clamp(min=0)

    with span("encode.clen_histogram"):
        clen_key = b_idx.unsqueeze(1) * C.NUM_CLEN + rle_sym_c
        clen_freq = huffman.histogram(clen_key, NB * C.NUM_CLEN,
                                      mask=rle_emitted).view(NB, C.NUM_CLEN)
    with span("encode.huffman_codes"):
        clen_len, _, clen_rev = huffman_codes(_force_two_codes(clen_freq), 7)

    with span("encode.bit_costs"):
        lens_perm = clen_len[:, K["clen_order"]]
        ar_c = torch.arange(C.NUM_CLEN, device=dev)
        hclen = (torch.where(lens_perm > 0, ar_c, 0).amax(1) + 1).clamp(min=4)

        # --------------------------------------------------------- bit costs
        ll_extra_tot = (ll_freq[:, 257:286] * K["len_extra"]).sum(1)
        d_extra_tot = (d_freq * K["dist_extra"]).sum(1)
        dyn_payload = ((ll_freq * ll_len_dyn).sum(1) + ll_extra_tot
                       + (d_freq * d_len_dyn).sum(1) + d_extra_tot)
        rle_code_bits = torch.gather(clen_len, 1, rle_sym_c)
        rle_bits_mat = torch.where(rle_emitted, rle_code_bits + rle_eb, 0)
        tree_bits = 14 + 3 * hclen + rle_bits_mat.sum(1)
        dyn_cost = 3 + tree_bits + dyn_payload

        fll, fdl = K["fixed_ll_len"], K["fixed_d_len"]
        fix_cost = (3 + (ll_freq * fll).sum(1) + ll_extra_tot
                    + (d_freq * fdl).sum(1) + d_extra_tot)

        blen = (end_pos_b.clamp(max=valid_len) - start_pos_b).clamp(0, S)
        sto_cost = 3 + 7 + 32 + 8 * blen
        # stored blocks are single-tile only (LEN is 16-bit)
        sto_cost = torch.where(n_micros_b == 1, sto_cost, 1 << 30)

        costs = torch.stack([sto_cost, fix_cost, dyn_cost], dim=1)
        btype = torch.argmin(costs, dim=1)           # 0/1/2 == RFC BTYPE
        if force_btype is not None:
            btype = torch.full_like(btype, force_btype)

    with span("encode.code_tables"):
        # effective per-block code tables
        use_dyn = (btype == C.BTYPE_DYNAMIC).unsqueeze(1)
        ll_len_eff = torch.where(use_dyn, ll_len_dyn, fll)
        d_len_eff = torch.where(use_dyn, d_len_dyn, fdl)
        # one table word per symbol: reversed code | len << 16; a zero column
        # at the end serves the masked symbol (NUM_LITLEN / NUM_DIST)
        zcol = torch.zeros((NB, 1), **i64)
        ll_tab = torch.cat([torch.where(use_dyn, ll_rev_dyn, K["fixed_ll_rev"])
                            | (ll_len_eff << 16), zcol], 1)
        d_tab = torch.cat([torch.where(use_dyn, d_rev_dyn, K["fixed_d_rev"])
                           | (d_len_eff << 16), zcol], 1)

        huff_b = (btype != C.BTYPE_STORED) & b_emitted
        eob_tab = ll_tab[:, C.EOB]
        eob_nbs = torch.where(huff_b, eob_tab >> 16, 0)

    # ------------------------------------------------------ header items
    with span("encode.header_items"):
        hdr_lo = torch.zeros((NB, _H_ITEMS), **i64)
        hdr_nbs = torch.zeros((NB, _H_ITEMS), **i64)
        is_dyn = btype == C.BTYPE_DYNAMIC
        is_sto = btype == C.BTYPE_STORED
        dyn_emit = b_emitted & is_dyn
        sto_emit = b_emitted & is_sto
        bfinal = (b_idx == LB) & final
        hdr_lo[:, 0] = bfinal.long() | (btype << 1)
        hdr_nbs[:, 0] = torch.where(b_emitted, 3, 0)

        hdr_lo[:, 1] = (hlit - 257) | ((hdist - 1) << 5) | ((hclen - 4) << 10)
        hdr_nbs[:, 1] = torch.where(dyn_emit, 14, 0)

        j19 = torch.arange(19, device=dev).unsqueeze(0)
        hdr_lo[:, 2:21] = lens_perm
        hdr_nbs[:, 2:21] = torch.where(
            dyn_emit.unsqueeze(1) & (j19 < hclen.unsqueeze(1)), 3, 0)

        # RLE symbol + its extra bits as one <= 14-bit item per slot
        rle_code = torch.gather(clen_rev, 1, rle_sym_c)
        hdr_lo[:, 21:21 + _RLE_SLOTS] = rle_code | (rle_ev << rle_code_bits)
        hdr_nbs[:, 21:21 + _RLE_SLOTS] = torch.where(
            dyn_emit.unsqueeze(1) & rle_emitted, rle_code_bits + rle_eb, 0)

        # stored: pad (filled after the layout), LEN/NLEN; payloads below
        hdr_lo[:, _SLOT_LENNLEN] = blen | ((~blen & 0xFFFF) << 16)
        hdr_nbs[:, _SLOT_LENNLEN] = torch.where(sto_emit, 32, 0)

        # EOB: last item of each block's row, offset set to the token end
        hdr_lo[:, _SLOT_EOB] = eob_tab & 0x7FFF
        hdr_nbs[:, _SLOT_EOB] = eob_nbs

    # ---------------------------------------- sub-block decode entries
    with span("encode.sub_entries"):
        # every `stride`-th Huffman token plus each block's first one, the
        # stride chosen so the entries fit NSUB lanes; a tile's chosen
        # positions are its litlen histogram's sum (the others map to the
        # dropped symbol), so no position is read here: pack_words selects them
        NSUB = S // 64
        n_tok_h = (ll_freq_micro.sum(1) * huff_b[blk_id_micro]).sum()
        stride = torch.div(n_tok_h + NSUB - NB - 1, NSUB - NB,
                           rounding_mode="floor").clamp(min=1)
        if _test_stride is not None:      # test seam: force sub_overflow
            stride = torch.tensor(_test_stride, **i64)
        n_tokens = ll_freq_micro.sum() + LB + 1
        n_matches = ll_freq_micro[:, C.EOB + 1:].sum()

    # ------------ token items, layout, offsets, words, entries (1 launch)
    with span("encode.pack_words"):
        # hdr_nbs's pad slot is 0 here: pack_words fills it in its own rows
        pk = pack_words(data, chosen, length, dist, blk_id_micro,
                        start_micro_c, huff_b, sto_emit, blen, ll_tab, d_tab,
                        hdr_lo, hdr_nbs, stride, final, OUT_WORDS)
        hdr_fixed = hdr_nbs.sum(1)              # without pad, with the EOB
    return {
        "words": pk.words,
        "total_bits": pk.total_bits,
        "btype": torch.where(b_emitted, btype, -1),
        "block_bits": torch.where(b_emitted,
                                  hdr_fixed + pk.pad + pk.token_bits, 0),
        "block_bytes": blen,
        "tree_bits": torch.where(dyn_emit, tree_bits, 0),
        "n_tokens": n_tokens,
        "n_matches": n_matches,
        "block_bit_base": torch.where(b_emitted, pk.block_base, 0),
        "block_out_start": torch.where(b_emitted, start_pos_b, 0),
        "n_blocks": LB + 1,
        "sub_bit": pk.sub_bit,
        "sub_out": pk.sub_out,
        "sub_blk": pk.sub_blk,
        "sub_overflow": pk.sub_overflow,
    }


def shard_bytes(r: dict) -> bytes:
    """Host bytes of one encoded shard's substream."""
    tb = int(r["total_bits"])
    nw = (tb + 31) // 32
    return bits_mod.words_to_bytes(r["words"][:nw].cpu().numpy(), tb)


def encode_shards(raw: bytes, shard_size: int, device: torch.device,
                  **options):
    """Yield encode_shard's result for each `shard_size` slice of non-empty
    `raw` in turn, the last one final; the slices are zero-padded on the
    host and encoded on `device`."""
    nsh = (len(raw) + shard_size - 1) // shard_size
    for s in range(nsh):
        with span("codec.upload"):
            part = raw[s * shard_size:(s + 1) * shard_size]
            buf = np.zeros(shard_size, dtype=np.uint8)
            buf[:len(part)] = np.frombuffer(part, dtype=np.uint8)
            x = torch.from_numpy(buf).to(device)
        yield encode_shard(x, len(part), s == nsh - 1, **options)


def deflate_compress_bytes(raw: bytes, shard_size: int = 1 << 20,
                           num_candidates: int = 32, lazy: bool = True,
                           device=None) -> bytes:
    """Host convenience: raw bytes -> one complete DEFLATE stream, the
    shards encoded in turn on `device` (CUDA unless "cpu" is asked for)."""
    dev = pick_device(device)
    if len(raw) == 0:
        return b"\x01\x00\x00\xff\xff"      # one empty final stored block
    shard_size = max(BLOCK, (shard_size // BLOCK) * BLOCK)
    return b"".join(shard_bytes(r) for r in encode_shards(
        raw, shard_size, dev, num_candidates=num_candidates, lazy=lazy))
