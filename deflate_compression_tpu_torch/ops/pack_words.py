"""The shard encoder's bit-pack: CUDA kernel wrapper and its plain version.

Counterpart of deflate_compression_tpu/format/deflate.py:421-676, which
the JAX package left to XLA: it has no Pallas kernel. From the tokens and
the per-block code tables and header items, the token items, the block
layout, the item offsets, the packs into u32 words (core/bits.py's
`pack_items64_to_words` and `pack_items96_to_words`), the stored payloads
and the sub-block decode entries.

The kernel (`csrc/pack_words.cu`: one pass over the positions, a CTA per
4,096 of them, the layout and the entries' ranks carried by a decoupled
look-back over maps of `csrc/layout_scan.cuh`; one memset and one launch)
is built at first use by `ops/cuda_build.py` and called through ctypes on
PyTorch's current stream. `pack_words` launches it for CUDA tensors and
raises if it cannot; it takes the plain version `pack_words_ref` only for
tensors that lie on the CPU. `pack_words.launches` counts kernel launches
(one a call).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import bits as bits_mod
from ..core.u32 import low_mask, shl32
from ..format import constants as C
from .block_layout import block_layout_ref
from . import cuda_build

SOURCE = cuda_build.CSRC / "pack_words.cu"
BLOCK = C.WINDOW_SIZE            # 32768 positions a tile
UNIT = 4096                      # positions a CTA of the kernel
RLE_SLOTS = 316                  # max hlit (286) + max hdist (30)
# header item slots per block: 3-bit hdr | 14-bit dynhdr | 19 clen | RLE
# | stored pad | LEN/NLEN | EOB
H_ITEMS = 1 + 1 + 19 + RLE_SLOTS + 1 + 1 + 1
SLOT_PAD = 337
SLOT_LENNLEN = 338
SLOT_EOB = H_ITEMS - 1
MAX_TILES = 32767                # S < 2^30


NO_POS = 1 << 30                 # an unused entry's position


class Packed(NamedTuple):
    words: torch.Tensor          # int64[num_words], u32 values
    total_bits: torch.Tensor     # int64 scalar
    block_base: torch.Tensor     # int64[NB]: each block's first bit
    pad: torch.Tensor            # int64[NB]: a stored block's pad
    token_bits: torch.Tensor     # int64[NB]: T_b
    sub_bit: torch.Tensor        # int64[NSUB]: an entry's bit offset, or -1
    sub_out: torch.Tensor        # int64[NSUB]: its position, or 2^30
    sub_blk: torch.Tensor        # int64[NSUB]: its block, or -1
    sub_overflow: torch.Tensor   # bool scalar: an entry ranked >= NSUB


def _ilog2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v < 2^24: the f32 biased exponent."""
    return (v.float().view(torch.int32).long() >> 23) - 127


def len_fields(length: torch.Tensor):
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


def dist_fields(dist: torch.Tensor):
    """Distance (1..32768) -> (code 0..29, extra value, extra bits), RFC
    1951 §3.2.5 Table 2 in closed form."""
    v = dist.clamp(min=1) - 1
    k = _ilog2(v.clamp(min=1))
    code_hi = 2 * k + (v >> (k - 1).clamp(min=0)) - 2
    code = torch.where(v < 4, v, code_hi)
    eb = torch.where(v < 4, 0, k - 1)
    ev = v & ((torch.ones_like(eb) << eb) - 1)
    return code, ev, eb


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {
        "pack_words_launch": [*[vp] * 14, i64, i32, i64, vp, vp, vp, i32,
                              vp],
        "pack_words_resident": [i32, ctypes.POINTER(i32)]})
    return lib, cuda_build.raw_stream()


def resident_units(dev: torch.device) -> int:
    """The kernel's CTAs (units of 4,096 positions) that the card holds at
    once: a shard of more units has some wait for a free multiprocessor."""
    lib, _ = _bind()
    n = ctypes.c_int(0)
    rc = lib.pack_words_resident(dev.index or 0, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"pack_words occupancy query failed: cudaError "
                           f"{rc}")
    return n.value


def _check(args: dict, num_words: int) -> None:
    for name, x in args.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.device != args["data"].device:
            raise ValueError(f"{name} is on {x.device}, data on "
                             f"{args['data'].device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S = args["data"].shape[0] if args["data"].dim() == 1 else -1
    NB = S // BLOCK
    if S < BLOCK or S % BLOCK or NB > MAX_TILES:
        raise ValueError(f"data must be u8[S] with S a positive multiple of "
                         f"{BLOCK} below 2^30, got {tuple(args['data'].shape)}")
    want = {"data": (torch.uint8, (S,)), "chosen": (torch.bool, (S,)),
            "length": (torch.int64, (S,)), "dist": (torch.int64, (S,)),
            "blk_id": (torch.int64, (NB,)),
            "start_tile": (torch.int64, (NB,)),
            "huff": (torch.bool, (NB,)), "stored": (torch.bool, (NB,)),
            "blen": (torch.int64, (NB,)),
            "ll_tab": (torch.int64, (NB, C.NUM_LITLEN + 1)),
            "d_tab": (torch.int64, (NB, C.NUM_DIST + 1)),
            "hdr_lo": (torch.int64, (NB, H_ITEMS)),
            "hdr_nbs": (torch.int64, (NB, H_ITEMS))}
    for name, (dtype, shape) in want.items():
        x = args[name]
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"want {name} {dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    st = args["stride"]
    if st.dtype != torch.int64 or st.numel() != 1:
        raise ValueError(f"want stride an int64 scalar, got {st.dtype} "
                         f"{tuple(st.shape)}")
    if num_words < 1:
        raise ValueError("num_words must be positive")


def pack_words_ref(data, chosen, length, dist, blk_id, start_tile, huff,
                   stored, blen, ll_tab, d_tab, hdr_lo, hdr_nbs, stride,
                   final: bool, num_words: int) -> Packed:
    """Plain PyTorch version of the kernel (format/deflate.py's own code
    before the kernel). Arguments and result as for `pack_words`."""
    S = data.shape[0]
    NB = S // BLOCK
    dev = data.device
    i64 = {"dtype": torch.int64, "device": dev}
    blk_id_micro, huff_b, sto_emit = blk_id, huff, stored

    # ------------------------------------------------------- token items
    is_match = chosen & (length >= C.MIN_MATCH)
    lcode, ll_ev_pos, leb = len_fields(length)
    ll_sym_t = torch.where(chosen, torch.where(is_match, lcode, data.long()),
                           C.NUM_LITLEN)
    ll_ev_pos = torch.where(is_match, ll_ev_pos, 0)
    ll_eb_pos = torch.where(is_match, leb, 0)
    dcode, d_ev_pos, deb = dist_fields(dist)
    d_sym_t = torch.where(is_match, dcode, C.NUM_DIST)
    d_ev_pos = torch.where(is_match, d_ev_pos, 0)
    d_eb_pos = torch.where(is_match, deb, 0)
    # per-position table lookup from its tile's block table (a gather; the
    # JAX package uses a one-hot matmul here only to dodge TPU gathers)
    tabv_ll = torch.gather(ll_tab[blk_id_micro], 1,
                           ll_sym_t.view(NB, BLOCK)).view(S)
    tabv_d = torch.gather(d_tab[blk_id_micro], 1,
                          d_sym_t.view(NB, BLOCK)).view(S)
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

    # ------------------------------------------- block layout (NB steps)
    hdr_fixed = hdr_nbs.sum(1)              # without pad, with the EOB
    eob_nbs = hdr_nbs[:, SLOT_EOB]
    pay_bits_b = torch.where(sto_emit, 8 * blen, 0)
    block_base, pad_b, p_end = block_layout_ref(hdr_fixed + T_b + pay_bits_b,
                                                sto_emit)
    hdr_nbs = hdr_nbs.clone()
    hdr_nbs[:, SLOT_PAD] = pad_b

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
    hdr_offs[:, SLOT_EOB] = token_base + T_b
    # position offsets: the global exclusive cumsum rebased per block
    rebase_b = token_base - P_excl[start_tile * BLOCK]
    off_pos = rebase_b[blk_id_micro].repeat_interleave(BLOCK) + P_excl

    n_h = NB * H_ITEMS + 3
    words_h = bits_mod.pack_items64_to_words(
        torch.cat([hdr_lo.reshape(-1), tail_vals]),
        torch.zeros(n_h, **i64),
        torch.cat([hdr_nbs.reshape(-1), tail_nbs]),
        torch.cat([hdr_offs.reshape(-1), tail_offs]),
        num_words)

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
                                             off_pos[0::2], num_words)
    words = words_h | words_t

    # stored payloads: per emitted stored block, add its tile's bytes
    # (masked to blen, shifted to the byte-aligned start) into the words
    PWs = BLOCK // 4
    q = data.long().view(S // 4, 4)
    tile_words = (q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)
                  | (q[:, 3] << 24)).view(NB, PWs)
    byte0 = (block_base + 3 + pad_b + 32) >> 3
    w0 = (byte0 >> 2).clamp(0, num_words - 1)
    sh = ((byte0 & 3) << 3).unsqueeze(1)          # 0/8/16/24
    nby = 8 * (blen.unsqueeze(1)
               - 4 * torch.arange(PWs, device=dev)).clamp(0, 4)
    sv = tile_words[start_tile] & low_mask(nby)
    prev = torch.cat([torch.zeros((NB, 1), **i64), sv[:, :-1]], 1)
    shifted = shl32(sv, sh) | (prev >> (32 - sh))
    carry = sv[:, -1:] >> (32 - sh)
    win = torch.where(sto_emit.unsqueeze(1),
                      torch.cat([shifted, carry], 1), 0)
    widx = w0.unsqueeze(1) + torch.arange(PWs + 1, device=dev)
    buf = torch.cat([words, torch.zeros(PWs + 1, **i64)])
    buf.index_add_(0, widx.reshape(-1), win.reshape(-1))
    words = buf[:num_words]

    # ------------------------------------- sub-block decode entries
    # every `stride`-th Huffman token plus each block's first one, at
    # their ranks among the selected (format/deflate.py:643-676)
    NSUB = S // 64
    tok_h = chosen & huff_pos
    th = tok_h.long()
    cs = torch.cumsum(th, 0) - th
    csb = cs[start_tile * BLOCK][blk_id_micro].repeat_interleave(BLOCK)
    first_in_blk = tok_h & (cs == csb)
    sel = tok_h & ((cs % stride.reshape(()).clamp(min=1) == 0)
                   | first_in_blk)
    sl = sel.long()
    sel_rank = torch.cumsum(sl, 0) - sl
    # overflow drops the entry and raises a loud stat
    sub_overflow = (sel & (sel_rank >= NSUB)).any()
    tgt_e = torch.where(sel & (sel_rank < NSUB), sel_rank, NSUB)
    sub = torch.full((NSUB + 1, 3), -1, **i64)
    sub[:, 1] = NO_POS
    sub[tgt_e] = torch.stack([off_pos, torch.arange(S, device=dev),
                              blk_id_micro.repeat_interleave(BLOCK)], 1)
    return Packed(words, total_bits, block_base, pad_b, T_b, sub[:NSUB, 0],
                  sub[:NSUB, 1], sub[:NSUB, 2], sub_overflow)


def pack_words(data, chosen, length, dist, blk_id, start_tile, huff,
               stored, blen, ll_tab, d_tab, hdr_lo, hdr_nbs, stride,
               final: bool, num_words: int,
               stats: dict | None = None) -> Packed:
    """Serialize one shard's tokens and blocks into u32 words.

    data u8[S] (S a positive multiple of 32768 below 2^30); chosen bool[S],
    length and dist int64[S]: `core/lz77.py::tokenize`'s tokens (a match
    has length in [3, 258] and dist in [1, 32768]). Per tile (NB = S /
    32768): blk_id int64[NB], its coding block (0 first, non-decreasing).
    Per coding block (NB buckets, those past the last block unused):
    start_tile int64[NB], its first tile; huff bool[NB], emitted with
    Huffman codes; stored bool[NB], emitted stored, with blen int64[NB]
    bytes from its tile; ll_tab int64[NB, 287] and d_tab int64[NB, 31],
    each symbol's reversed code | length << 16 (codes of at most 15 bits;
    the last column is unused); hdr_lo and hdr_nbs int64[NB, 340], the
    header items' values and widths (slot 337, the pad, is filled in here;
    slot 339 is the EOB). stride: an int64 scalar >= 1, the decode
    entries' stride among the Huffman tokens (chosen positions of blocks
    with `huff`). final: no empty stored block after the last block. All
    contiguous, on one device.

    Returns `Packed`: words int64[num_words] holding the u32 words (past
    total_bits 0), total_bits, block_base, pad and token_bits int64[NB];
    the decode entries sub_bit, sub_out and sub_blk int64[NSUB] (NSUB = S
    / 64): each Huffman token whose rank among them is a multiple of the
    stride, or which is its block's first, at its rank among those (its
    item's bit offset, its position, its block), the slots left (-1,
    2^30, -1); sub_overflow, whether one ranked >= NSUB and was dropped.
    A CUDA tensor goes through the CUDA kernel (one memset and one launch,
    or this raises); a CPU tensor through `pack_words_ref`. On the card a
    `stats` dict gets "lookback_cycles" (each unit's wait in its look-back,
    clock64 cycles), "start_ns", "aggregate_ns" and "end_ns" (each unit's
    CTA's start, its aggregate's publication and its end on the
    globaltimer), "found_cycles" (the look-back's cycles to the nearest
    inclusive prefix) and "start_cycles", "end_cycles" (its SM's clock64 at
    its start and its end: with start_ns and end_ns they convert this
    launch's cycles to ns), int64[NU] each (NU = S / 4096)."""
    args = {"data": data, "chosen": chosen, "length": length, "dist": dist,
            "blk_id": blk_id, "start_tile": start_tile, "huff": huff,
            "stored": stored, "blen": blen, "ll_tab": ll_tab,
            "d_tab": d_tab, "hdr_lo": hdr_lo, "hdr_nbs": hdr_nbs,
            "stride": stride}
    num_words = int(num_words)
    _check(args, num_words)
    dev = data.device
    if dev.type == "cpu":
        return pack_words_ref(*args.values(), bool(final), num_words)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # the kernel loads positions 16 bytes at a time
    for name in ("data", "chosen", "length", "dist"):
        if args[name].data_ptr() % 16:
            args[name] = args[name].clone()
    S = data.shape[0]
    NB, NU, NSUB = S // BLOCK, S // UNIT, S // 64
    # words | base, pad, T_b | total_bits, p_end, overflow, counter | the
    # look-back's status words and second words: zeroed by one memset
    buf = torch.empty(num_words + 3 * NB + 4 + 2 * NU, dtype=torch.int64,
                      device=dev)
    entries = torch.empty((3, NSUB), dtype=torch.int64, device=dev)
    st = torch.empty((NU, 7), dtype=torch.int64, device=dev) \
        if stats is not None else None
    lib, stream = _bind()
    rc = lib.pack_words_launch(
        *[x.data_ptr() for x in args.values()], S, int(bool(final)),
        num_words, buf.data_ptr(), entries.data_ptr(),
        st.data_ptr() if st is not None else None, dev.index,
        stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"pack_words launch failed: cudaError {rc}")
    pack_words.launches += 1
    if st is not None:
        stats.update(lookback_cycles=st[:, 0], start_ns=st[:, 1],
                     aggregate_ns=st[:, 2], end_ns=st[:, 3],
                     found_cycles=st[:, 4], start_cycles=st[:, 5],
                     end_cycles=st[:, 6])
    o = num_words + 3 * NB
    return Packed(buf[:num_words], buf[o], buf[num_words:num_words + NB],
                  buf[num_words + NB:num_words + 2 * NB],
                  buf[num_words + 2 * NB:o], entries[0], entries[1],
                  entries[2], buf[o + 2:o + 3].view(torch.bool)[0])


pack_words.launches = 0
