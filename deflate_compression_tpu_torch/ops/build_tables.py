"""Phase A of the device decoder, block headers and decode tables: CUDA
kernel wrapper and its plain version.

Counterpart of the JAX decoder's phase A (decode/tpu_inflate.py:352-455:
`rle_body`, `_canon_first`, `_sym_tables`), which the JAX package left to
XLA: it has no Pallas kernel. Per coding block slot: the BTYPE classes;
HLIT/HDIST/HCLEN; the 19 code-length lengths; the RLE loop over at most 316
code lengths; the fixed block's lengths; and for both alphabets the Kraft
flag, the count of codes per length, the symbols in canonical order and the
2^11-entry primary LUT of ops/decode_symbols.py (LONG_CODE where only
longer codes share a prefix). The kernel (`csrc/build_tables.cu`) is built
at first use by `ops/cuda_build.py` and called through ctypes on PyTorch's
current stream; it takes one CTA per block slot and waits for nothing.

`build_tables` launches its kernel for CUDA tensors and raises if it
cannot; it takes the plain version `build_tables_ref` only for tensors that
lie on the CPU. `build_tables.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import typing

import numpy as np
import torch

from ..core.bits import reverse_bits
from ..core.huffman import canonical_codes
from ..format import constants as C
from . import cuda_build
from . import decode_symbols as DS

SOURCE = cuda_build.CSRC / "build_tables.cu"
RLE_W = C.NUM_LITLEN + C.NUM_DIST             # 316 code lengths at most
RLE_STEPS = RLE_W + 4                         # the JAX loop's step bound
_RLE_CHECK = 8                                # steps between exit checks

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


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {"build_tables_launch": [
        vp, i64, vp, vp, vp, i64, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ctypes.c_int, vp]})
    return lib.build_tables_launch, cuda_build.raw_stream()


# ------------------------------------------------------------ plain version

def peek32(w: torch.Tensor, bit_pos: torch.Tensor) -> torch.Tensor:
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


def build_tables_ref(w: torch.Tensor, blk_bit, blk_btype,
                     n_blocks) -> PhaseA:
    """Plain version of the kernel (tpu_inflate.py:352-454): every step
    vectorized over the block slots, the RLE loop as masked steps.
    Arguments as for `build_tables`."""
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
    hw = peek32(w, bp)
    hlit = torch.where(is_dyn, (hw & 31) + 257, 257)
    hdist = torch.where(is_dyn, ((hw >> 5) & 31) + 1, 1)
    hclen = torch.where(is_dyn, ((hw >> 10) & 15) + 4, 4)
    bbad = bbad | (is_dyn & ((hlit > 286) | (hdist > 30)))
    bp = torch.where(is_dyn, bp + 14, bp)

    # the j-th transmitted clen length sits at bp + 3j
    j = torch.arange(C.NUM_CLEN, device=dev)
    v = peek32(w, bp.unsqueeze(1) + 3 * j) & 7
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
    t316 = torch.arange(RLE_W, device=dev)
    i = torch.zeros(NB, dtype=torch.int64, device=dev)
    prev = torch.full((NB,), -1, dtype=torch.int64, device=dev)
    lens = torch.zeros((NB, RLE_W), dtype=torch.int64, device=dev)
    bad = bbad
    for step in range(RLE_STEPS):
        act = is_dyn & (i < total) & ~bad
        if step % _RLE_CHECK == 0 and not bool(act.any()):
            break
        lo = peek32(w, bp)
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
        # a repeat with no previous length (prev -1) flags the block bad
        # and leaves its lengths absent (0), as the JAX tables read a -1
        lens = torch.where(cover, fill.clamp(min=0).unsqueeze(1), lens)
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
    d_lens = lens.gather(1, (hlit.unsqueeze(1) + td).clamp(0, RLE_W - 1))
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


# ------------------------------------------------------------------ wrapper

def _check(w, blk_bit, blk_btype, n_blocks) -> None:
    dev = w.device
    if w.dtype != torch.int64 or w.dim() != 1:
        raise TypeError("w must be 1-D int64 (u32 values)")
    NB = blk_bit.shape[0]
    for name, t in (("blk_bit", blk_bit), ("blk_btype", blk_btype)):
        if t.dtype != torch.int64 or t.shape != (NB,) or t.device != dev:
            raise ValueError(f"{name} must be int64[{NB}] on {dev}")
    if isinstance(n_blocks, torch.Tensor) and (
            n_blocks.numel() != 1 or n_blocks.device != dev):
        raise ValueError(f"n_blocks must be an int or one integer on {dev}")


def build_tables(w: torch.Tensor, blk_bit: torch.Tensor,
                 blk_btype: torch.Tensor, n_blocks) -> PhaseA:
    """Block headers and phase-B tables of every block slot.

    w: i64[CW] stream words (u32 values). blk_bit, blk_btype: i64[NB] bit
    offset of each block's 3-bit header and its BTYPE (-1: unused slot).
    n_blocks: the live block count, an int or one integer on w's device
    (the kernel reads it there, so a tensor is never waited for). A CUDA
    tensor goes through the kernel
    (or this raises); a CPU tensor through `build_tables_ref`."""
    _check(w, blk_bit, blk_btype, n_blocks)
    dev = w.device
    if dev.type == "cpu":
        return build_tables_ref(w, blk_bit, blk_btype, n_blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    NB = blk_bit.shape[0]
    if w.shape[0] < 1:
        raise ValueError("w must hold at least one word")

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)
    tables = DS.SymbolTables(i32(NB, DS.LUT_SIZE), i32(NB, DS.LUT_SIZE),
                             i32(NB, DS.MAX_BITS + 1),
                             i32(NB, DS.MAX_BITS + 1), i32(NB, DS.N_LL),
                             i32(NB, DS.N_D))
    hdr_end = torch.empty(NB, dtype=torch.int64, device=dev)
    flags = [torch.empty(NB, dtype=torch.bool, device=dev) for _ in range(4)]
    a = PhaseA(tables, hdr_end, *flags)
    if NB == 0:
        return a
    w, blk_bit, blk_btype = (x.contiguous() for x in (w, blk_bit, blk_btype))
    n_live = torch.as_tensor(n_blocks, device=dev).to(torch.int64).reshape(1)
    launch, stream = _bind()
    rc = launch(w.data_ptr(), w.shape[0], blk_bit.data_ptr(),
                blk_btype.data_ptr(), n_live.data_ptr(), NB,
                *(x.data_ptr() for x in tables), hdr_end.data_ptr(),
                *(x.data_ptr() for x in flags), dev.index, stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"build_tables launch failed: cudaError {rc}")
    build_tables.launches += 1
    return a


build_tables.launches = 0
