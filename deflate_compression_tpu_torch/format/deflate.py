"""DEFLATE shard encoder: tokens -> RFC 1951 bitstream (counterpart of
deflate_compression_tpu/format/deflate.py).

One shard (S bytes, S % 32768 == 0) is tokenized once, cut into
NB = S / 32768 tiles, planned into coding blocks (core/cost.py), given
per-block length-limited Huffman tables (core/huffman.py) and serialized as
items (value, nbits, bit offset) packed into LSB-first words
(core/bits.py). The only sequential pieces are two NB-step loops: the
block layout (stored-block byte alignment) and the cost DP. A non-final
shard ends with an empty stored block, so shard substreams concatenate.

The output is bit-identical to the JAX encoder's for the same input and
options. u32 values are carried in int64 tensors (core/u32.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import bits as bits_mod
from ..core import huffman, lz77
from ..core.cost import block_plan
from ..core import scans
from ..core.u32 import low_mask, shl32
from ..device import pick_device
from . import constants as C

BLOCK = C.WINDOW_SIZE            # 32768 input bytes per tile
_RLE_SLOTS = 316                 # max hlit (286) + max hdist (30)
# header item slots per block: 3-bit hdr | 14-bit dynhdr | 19 clen | RLE
# | stored pad | LEN/NLEN | EOB
_H_ITEMS = 1 + 1 + 19 + _RLE_SLOTS + 1 + 1 + 1
_SLOT_PAD = 337
_SLOT_LENNLEN = 338
_SLOT_EOB = _H_ITEMS - 1
TREE_LIMIT = 11                  # emitted Huffman code-length cap
MAX_MERGE = 8                    # most tiles merged into one coding block

_FIXED_LL_LEN = C.FIXED_LITLEN_LENGTHS[:C.NUM_LITLEN]
_FIXED_LL_CODE = huffman.canonical_codes_np(C.FIXED_LITLEN_LENGTHS,
                                            15)[:C.NUM_LITLEN]
_FIXED_D_LEN = C.FIXED_DIST_LENGTHS[:C.NUM_DIST]
_FIXED_D_CODE = huffman.canonical_codes_np(C.FIXED_DIST_LENGTHS,
                                           15)[:C.NUM_DIST]


def out_words(shard_size: int) -> int:
    """Worst-case output capacity (u32 words) for a shard."""
    nb = shard_size // BLOCK
    return (nb * (42 + 9 * BLOCK) + 96) // 32


def _ilog2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v < 2^24: the f32 biased exponent."""
    return (v.float().view(torch.int32).long() >> 23) - 127


def _len_fields(length: torch.Tensor):
    """Match length (3..258) -> (code 257..285, extra value, extra bits),
    RFC 1951 §3.2.5 Table 1 in closed form. Callers mask literals."""
    m = (length - C.MIN_MATCH).clamp(0, 255)
    k = _ilog2(m.clamp(min=1))
    eb = (k - 2).clamp(min=0)
    code_hi = 257 + 4 * (k - 1) + ((m - (torch.ones_like(k) << k)) >> eb)
    code = torch.where(m < 8, 257 + m, code_hi)
    code = torch.where(m >= 255, 285, code)          # length 258 is exact
    eb = torch.where((m < 8) | (m >= 255), 0, eb)
    ev = m & ((torch.ones_like(eb) << eb) - 1)
    return code, ev, eb


def _dist_fields(dist: torch.Tensor):
    """Distance (1..32768) -> (code 0..29, extra value, extra bits), RFC
    1951 §3.2.5 Table 2 in closed form."""
    v = dist.clamp(min=1) - 1
    k = _ilog2(v.clamp(min=1))
    code_hi = 2 * k + (v >> (k - 1).clamp(min=0)) - 2
    code = torch.where(v < 4, v, code_hi)
    eb = torch.where(v < 4, 0, k - 1)
    ev = v & ((torch.ones_like(eb) << eb) - 1)
    return code, ev, eb


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

    data = data.to(torch.uint8)
    pos = torch.arange(S, device=dev)
    b_idx = torch.arange(NB, device=dev)
    LB_micro = max((valid_len - 1) // BLOCK, 0)

    # ------------------------------------------------------------- LZ77
    tok = lz77.tokenize(data, valid_len, num_candidates=num_candidates,
                        lazy=lazy)
    chosen, length, dist = tok["chosen"], tok["length"], tok["dist"]
    is_match = chosen & (length >= C.MIN_MATCH)
    len_extra = torch.as_tensor(C.LENGTH_EXTRA, **i64)
    dist_extra = torch.as_tensor(C.DIST_EXTRA, **i64)

    lcode, lev, leb = _len_fields(length)
    ll_sym_pos = torch.where(is_match, lcode, data.long())
    ll_ev_pos = torch.where(is_match, lev, 0)
    ll_eb_pos = torch.where(is_match, leb, 0)
    dcode, dev_, deb_ = _dist_fields(dist)
    d_sym_pos = torch.where(is_match, dcode, 0)
    d_ev_pos = torch.where(is_match, dev_, 0)
    d_eb_pos = torch.where(is_match, deb_, 0)

    # --------------------------------------------------- block planning
    # per-tile histograms (the tile_histogram kernel); masked positions
    # map to the dropped class
    ll_sym_t = torch.where(chosen, ll_sym_pos, C.NUM_LITLEN)
    ll_freq_micro = huffman.histogram_rows(ll_sym_t.view(NB, BLOCK),
                                           C.NUM_LITLEN)
    d_sym_t = torch.where(is_match, d_sym_pos, C.NUM_DIST)
    d_freq_micro = huffman.histogram_rows(d_sym_t.view(NB, BLOCK),
                                          C.NUM_DIST)

    if force_btype == C.BTYPE_FIXED and NB > 1:
        split = b_idx == 0           # fixed blocks carry no tree: one block
    elif force_btype == C.BTYPE_STORED:
        split = torch.ones(NB, dtype=torch.bool, device=dev)
    elif NB > 1:
        tile_bytes = (valid_len - b_idx * BLOCK).clamp(0, BLOCK)
        split, _ = block_plan(ll_freq_micro, d_freq_micro, LB_micro + 1,
                              tile_bytes, max_merge=MAX_MERGE)
    else:
        split = torch.ones(NB, dtype=torch.bool, device=dev)

    blk_id_micro = torch.cumsum(split.long(), dim=0) - 1
    blk_of_pos = blk_id_micro.repeat_interleave(BLOCK)
    LB = blk_id_micro[LB_micro]                  # last emitted coding block
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

    # litlen and zero-padded dist alphabets share one batched build
    d_freq_pad = torch.cat(
        [d_freq_t, torch.zeros((NB, C.NUM_LITLEN - C.NUM_DIST), **i64)], 1)
    both_len = huffman.huffman_code_lengths(
        torch.cat([ll_freq_t, d_freq_pad], 0), TREE_LIMIT)
    ll_len_dyn = both_len[:NB]
    d_len_dyn = both_len[NB:, :C.NUM_DIST]
    both_code = huffman.canonical_codes(both_len, TREE_LIMIT)
    ll_code_dyn = both_code[:NB]
    d_code_dyn = both_code[NB:, :C.NUM_DIST]

    # ------------------------------------------ tree description (RLE)
    ar_ll = torch.arange(C.NUM_LITLEN, device=dev)
    ar_d = torch.arange(C.NUM_DIST, device=dev)
    hlit = (torch.where(ll_len_dyn > 0, ar_ll, 0).amax(1) + 1).clamp(min=257)
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

    clen_key = b_idx.unsqueeze(1) * C.NUM_CLEN + rle_sym_c
    clen_freq = huffman.histogram(clen_key, NB * C.NUM_CLEN,
                                  mask=rle_emitted).view(NB, C.NUM_CLEN)
    clen_len = huffman.huffman_code_lengths(_force_two_codes(clen_freq), 7)
    clen_code = huffman.canonical_codes(clen_len, 7)

    lens_perm = clen_len[:, torch.as_tensor(C.CLEN_ORDER, **i64)]
    ar_c = torch.arange(C.NUM_CLEN, device=dev)
    hclen = (torch.where(lens_perm > 0, ar_c, 0).amax(1) + 1).clamp(min=4)

    # --------------------------------------------------------- bit costs
    ll_extra_tot = (ll_freq[:, 257:286] * len_extra).sum(1)
    d_extra_tot = (d_freq * dist_extra).sum(1)
    dyn_payload = ((ll_freq * ll_len_dyn).sum(1) + ll_extra_tot
                   + (d_freq * d_len_dyn).sum(1) + d_extra_tot)
    rle_code_bits = torch.gather(clen_len, 1, rle_sym_c)
    rle_bits_mat = torch.where(rle_emitted, rle_code_bits + rle_eb, 0)
    tree_bits = 14 + 3 * hclen + rle_bits_mat.sum(1)
    dyn_cost = 3 + tree_bits + dyn_payload

    fll = torch.as_tensor(_FIXED_LL_LEN, **i64)
    fdl = torch.as_tensor(_FIXED_D_LEN, **i64)
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

    # effective per-block code tables
    use_dyn = (btype == C.BTYPE_DYNAMIC).unsqueeze(1)
    ll_len_eff = torch.where(use_dyn, ll_len_dyn, fll)
    d_len_eff = torch.where(use_dyn, d_len_dyn, fdl)
    ll_code_eff = torch.where(use_dyn, ll_code_dyn,
                              torch.as_tensor(_FIXED_LL_CODE.astype(np.int64),
                                              **i64))
    d_code_eff = torch.where(use_dyn, d_code_dyn,
                             torch.as_tensor(_FIXED_D_CODE.astype(np.int64),
                                             **i64))
    # one table word per symbol: reversed code | len << 16; a zero column
    # at the end serves the masked symbol (NUM_LITLEN / NUM_DIST)
    zcol = torch.zeros((NB, 1), **i64)
    ll_tab = torch.cat([bits_mod.reverse_bits(ll_code_eff, ll_len_eff)
                        | (ll_len_eff << 16), zcol], 1)
    d_tab = torch.cat([bits_mod.reverse_bits(d_code_eff, d_len_eff)
                       | (d_len_eff << 16), zcol], 1)

    # ------------------------------------------------------- token items
    # per-position table lookup from its tile's block table (a gather; the
    # JAX package uses a one-hot matmul here only to dodge TPU gathers)
    tabv_ll = torch.gather(ll_tab[blk_id_micro], 1,
                           ll_sym_t.view(NB, BLOCK)).view(S)
    tabv_d = torch.gather(d_tab[blk_id_micro], 1,
                          d_sym_t.view(NB, BLOCK)).view(S)

    huff_b = (btype != C.BTYPE_STORED) & b_emitted
    huff_pos = huff_b[blk_id_micro].repeat_interleave(BLOCK)

    tk_ll_bits = tabv_ll >> 16
    tk_ll_code = tabv_ll & 0xFFFF
    tk_d_bits = tabv_d >> 16
    tk_d_code = tabv_d & 0xFFFF

    # one <= 48-bit item per token: litlen code+extra in the low bits,
    # dist code+extra above
    it_ll_val = tk_ll_code | (ll_ev_pos << tk_ll_bits)
    it_ll_nb = torch.where(huff_pos, tk_ll_bits + ll_eb_pos, 0)
    it_d_val = tk_d_code | (d_ev_pos << tk_d_bits)
    it_d_nb = torch.where(huff_pos & is_match, tk_d_bits + d_eb_pos, 0)

    lo_pos = it_ll_val | shl32(it_d_val, it_ll_nb)
    hi_pos = it_d_val >> (32 - it_ll_nb)
    nbs_pos = it_ll_nb + it_d_nb

    nbs_chosen = torch.where(chosen, nbs_pos, 0)
    micro_bits = nbs_chosen.view(NB, BLOCK).sum(1)
    T_b = torch.zeros(NB, **i64).index_add_(0, blk_id_micro, micro_bits)
    P_excl = torch.cumsum(nbs_chosen, 0) - nbs_chosen

    eob_tab = ll_tab[:, C.EOB]
    eob_nbs = torch.where(huff_b, eob_tab >> 16, 0)

    # ------------------------------------------------------ header items
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
    clen_code_rev = bits_mod.reverse_bits(clen_code, clen_len, 7)
    rle_code = torch.gather(clen_code_rev, 1, rle_sym_c)
    hdr_lo[:, 21:21 + _RLE_SLOTS] = rle_code | (rle_ev << rle_code_bits)
    hdr_nbs[:, 21:21 + _RLE_SLOTS] = torch.where(
        dyn_emit.unsqueeze(1) & rle_emitted, rle_code_bits + rle_eb, 0)

    # stored: pad (filled after the layout), LEN/NLEN; payloads below
    hdr_lo[:, _SLOT_LENNLEN] = blen | ((~blen & 0xFFFF) << 16)
    hdr_nbs[:, _SLOT_LENNLEN] = torch.where(sto_emit, 32, 0)

    # EOB: last item of each block's row, offset set to the token end
    hdr_lo[:, _SLOT_EOB] = eob_tab & 0x7FFF
    hdr_nbs[:, _SLOT_EOB] = eob_nbs

    # ------------------------------------------- block layout (NB steps)
    hdr_fixed = hdr_nbs.sum(1)              # without pad, with the EOB
    pay_bits_b = torch.where(sto_emit, 8 * blen, 0)
    rest_b = hdr_fixed + T_b + pay_bits_b
    p = torch.zeros((), **i64)
    bases, pads = [], []
    for b in range(NB):
        pad = torch.where(sto_emit[b], (8 - ((p + 3) % 8)) % 8, 0)
        bases.append(p)
        pads.append(pad)
        p = p + rest_b[b] + pad
    block_base = torch.stack(bases)
    pad_b = torch.stack(pads)
    p_end = p
    hdr_nbs[:, _SLOT_PAD] = pad_b

    # tail: sync flush when not final (empty stored block, byte aligned)
    sf_pad = (8 - ((p_end + 3) % 8)) % 8
    tail_vals = torch.tensor([0, 0, 0xFFFF0000], **i64)
    tail_offs = torch.stack([p_end, p_end + 3, p_end + 3 + sf_pad])
    if final:
        tail_nbs = torch.zeros(3, **i64)
        total_bits = p_end
    else:
        tail_nbs = torch.stack([torch.full_like(sf_pad, 3), sf_pad,
                                torch.full_like(sf_pad, 32)])
        total_bits = p_end + 3 + sf_pad + 32

    # ---------------------------------------------------- item offsets
    hdr_offs = block_base.unsqueeze(1) + torch.cumsum(hdr_nbs, 1) - hdr_nbs
    token_base = block_base + (hdr_fixed - eob_nbs) + pad_b
    hdr_offs[:, _SLOT_EOB] = token_base + T_b
    # position offsets: the global exclusive cumsum rebased per block
    rebase_b = token_base - P_excl[start_pos_b]
    off_pos = rebase_b[blk_id_micro].repeat_interleave(BLOCK) + P_excl

    n_h = NB * _H_ITEMS + 3
    words_h = bits_mod.pack_items64_to_words(
        torch.cat([hdr_lo.reshape(-1), tail_vals]),
        torch.zeros(n_h, **i64),
        torch.cat([hdr_nbs.reshape(-1), tail_nbs]),
        torch.cat([hdr_offs.reshape(-1), tail_offs]),
        OUT_WORDS)

    # pair adjacent positions into one <= 96-bit item: inside a block the
    # position offsets are gapless and pairs never straddle a block
    lo_m = lo_pos & low_mask(nbs_chosen)
    hi_m = hi_pos & low_mask(nbs_chosen - 32)
    l1, h1, n1 = lo_m[0::2], hi_m[0::2], nbs_chosen[0::2]
    l2, h2, n2 = lo_m[1::2], hi_m[1::2], nbs_chosen[1::2]
    hiq = n1 >= 32                    # the second item starts in word 1
    rsh = n1 & 31
    a0 = shl32(l2, rsh)
    a1 = shl32(h2, rsh) | (l2 >> (32 - rsh))
    a2 = h2 >> (32 - rsh)
    c0 = l1 | torch.where(hiq, 0, a0)
    c1 = h1 | torch.where(hiq, a0, a1)
    c2 = torch.where(hiq, a1, a2)     # bits >= 96 provably vanish
    words_t = bits_mod.pack_items96_to_words(c0, c1, c2, n1 + n2,
                                             off_pos[0::2], OUT_WORDS)
    words = words_h | words_t

    # stored payloads: per emitted stored block, add its tile's bytes
    # (masked to blen, shifted to the byte-aligned start) into the words
    PWs = BLOCK // 4
    q = data.long().view(S // 4, 4)
    tile_words = (q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)
                  | (q[:, 3] << 24)).view(NB, PWs)
    byte0 = (block_base + 3 + pad_b + 32) >> 3
    w0 = (byte0 >> 2).clamp(0, OUT_WORDS - 1)
    sh = ((byte0 & 3) << 3).unsqueeze(1)          # 0/8/16/24
    nby = 8 * (blen.unsqueeze(1)
               - 4 * torch.arange(PWs, device=dev)).clamp(0, 4)
    sv = tile_words[start_micro_c] & low_mask(nby)
    prev = torch.cat([torch.zeros((NB, 1), **i64), sv[:, :-1]], 1)
    shifted = shl32(sv, sh) | (prev >> (32 - sh))
    carry = sv[:, -1:] >> (32 - sh)
    win = torch.where(sto_emit.unsqueeze(1),
                      torch.cat([shifted, carry], 1), 0)
    widx = w0.unsqueeze(1) + torch.arange(PWs + 1, device=dev)
    buf = torch.cat([words, torch.zeros(PWs + 1, **i64)])
    buf.index_add_(0, widx.reshape(-1), win.reshape(-1))
    words = buf[:OUT_WORDS]

    # ---------------------------------------- sub-block decode entries
    # every `stride`-th Huffman token plus each block's first token, the
    # stride chosen so the entries fit NSUB lanes
    NSUB = S // 64
    tok_h = chosen & huff_pos
    th = tok_h.long()
    cs = torch.cumsum(th, 0) - th
    n_tok_h = cs[-1] + th[-1]
    csb = cs[start_pos_b][blk_id_micro].repeat_interleave(BLOCK)
    first_in_blk = tok_h & (cs == csb)
    stride = torch.div(n_tok_h + NSUB - NB - 1, NSUB - NB,
                       rounding_mode="floor").clamp(min=1)
    if _test_stride is not None:      # test seam: force sub_overflow
        stride = torch.tensor(_test_stride, **i64)
    sel = tok_h & ((cs % stride == 0) | first_in_blk)
    sl = sel.long()
    sel_rank = torch.cumsum(sl, 0) - sl
    # overflow drops the entry and raises a loud stat
    sub_overflow = (sel & (sel_rank >= NSUB)).any()
    tgt_e = torch.where(sel & (sel_rank < NSUB), sel_rank, NSUB)
    sub = torch.full((NSUB + 1, 3), -1, **i64)
    sub[:, 1] = 1 << 30
    sub[tgt_e] = torch.stack([off_pos, pos, blk_of_pos], dim=1)
    entry_bit, entry_pos, entry_blk = sub[:NSUB, 0], sub[:NSUB, 1], sub[:NSUB, 2]
    ev = entry_blk >= 0

    n_tokens = chosen.sum() + LB + 1
    n_matches = is_match.sum()
    return {
        "words": words,
        "total_bits": total_bits,
        "btype": torch.where(b_emitted, btype, -1),
        "block_bits": torch.where(b_emitted, hdr_fixed + pad_b + T_b, 0),
        "block_bytes": blen,
        "tree_bits": torch.where(dyn_emit, tree_bits, 0),
        "n_tokens": n_tokens,
        "n_matches": n_matches,
        "block_bit_base": torch.where(b_emitted, block_base, 0),
        "block_out_start": torch.where(b_emitted, start_pos_b, 0),
        "n_blocks": LB + 1,
        "sub_bit": torch.where(ev, entry_bit, -1),
        "sub_out": torch.where(ev, entry_pos, 1 << 30),
        "sub_blk": torch.where(ev, entry_blk, -1),
        "sub_overflow": sub_overflow,
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
        part = raw[s * shard_size:(s + 1) * shard_size]
        buf = np.zeros(shard_size, dtype=np.uint8)
        buf[:len(part)] = np.frombuffer(part, dtype=np.uint8)
        yield encode_shard(torch.from_numpy(buf).to(device), len(part),
                           s == nsh - 1, **options)


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
