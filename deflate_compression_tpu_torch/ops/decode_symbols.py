"""Phase-B symbol decode: CUDA kernel wrapper and its plain version.

Counterpart of the symbol loop of the JAX decoder
(decode/tpu_inflate.py `dec_body` / `one_sym_at`), with the shared-memory
LUT lookups that tools/probe_pallas_r5.py::try_lower tried to lower as a
Pallas TPU kernel. The kernel (`csrc/decode_symbols.cu`) is built at first
use by `ops/cuda_build.py` and called through ctypes on PyTorch's current
stream.

`decode_symbols` launches its kernel for CUDA tensors and raises if it
cannot; it takes the plain version `decode_symbols_ref` only for tensors
that lie on the CPU. `decode_symbols.launches` counts kernel launches.
On a CUDA tensor the wrapper never waits for the device: it zeroes the
tokens, allocates the lanes' results and launches; the kernel groups each
CTA's lanes by block itself (`cta_rounds` is that schedule in plain torch)
and takes the symbols' payloads from its constant memory.

Tables (one row per coding block, built by decode/device_inflate.py's
phase A): a 2^11-entry primary LUT per alphabet whose entry is the symbol's
payload | code length << 14 (litlen) or << 20 (dist), 0 for an invalid
prefix and LONG_CODE where only codes longer than 11 bits share the
prefix; and, for those, the canonical tables of the RFC 1951 §3.2.2 walk:
the count of codes per length and the symbols in canonical order.
"""
from __future__ import annotations

import ctypes
import functools
import typing

import numpy as np
import torch

from ..format import constants as C
from . import cuda_build

SOURCE = cuda_build.CSRC / "decode_symbols.cu"
LUT_BITS = 11
LUT_SIZE = 1 << LUT_BITS
LONG_CODE = 1 << 30
MAX_BITS = 15
N_LL = 288                       # decode-side litlen alphabet (286/287 bad)
N_D = 32                         # decode-side dist alphabet (30/31 bad)
THREADS = 256                    # lanes per CTA (kThreads in the source)
TABLE_SETS = 2                   # blocks' tables staged per round (kSets)

# Static per-symbol payloads (the JAX decoder's _LL_PAY_STATIC /
# _D_PAY_STATIC). litlen: value(9: literal byte or length base) |
# extra bits(3) << 9 | kind(2) << 12 (0 lit, 1 EOB, 2 length, 3 bad).
# dist: base(15) | extra bits(4) << 15 | bad(1) << 19.
_ls = np.arange(N_LL)
_lkind = np.where(_ls < 256, 0,
                  np.where(_ls == 256, 1, np.where(_ls < 286, 2, 3)))
_lli = np.clip(_ls - 257, 0, 28)
_lval = np.where(_lkind == 0, _ls,
                 np.where(_lkind == 2, C.LENGTH_BASE[_lli], 0))
_leb = np.where(_lkind == 2, C.LENGTH_EXTRA[_lli], 0)
LL_PAY = (_lval | (_leb << 9) | (_lkind << 12)).astype(np.int32)
_ds = np.arange(N_D)
_dsi = np.clip(_ds, 0, 29)
_dbad = (_ds >= 30).astype(np.int64)
D_PAY = (np.where(_dbad == 0, C.DIST_BASE[_dsi], 0)
         | (np.where(_dbad == 0, C.DIST_EXTRA[_dsi], 0) << 15)
         | (_dbad << 19)).astype(np.int32)
LL_SHIFT = 14                    # code length position in a litlen entry
D_SHIFT = 20                     # ... in a dist entry


class SymbolTables(typing.NamedTuple):
    """Per-block decode tables, all int32 and contiguous on one device."""
    ll_lut: torch.Tensor         # [NB, LUT_SIZE]
    d_lut: torch.Tensor          # [NB, LUT_SIZE]
    ll_cnt: torch.Tensor         # [NB, MAX_BITS + 1] codes per length
    d_cnt: torch.Tensor          # [NB, MAX_BITS + 1]
    ll_sym: torch.Tensor         # [NB, N_LL] symbols in canonical order
    d_sym: torch.Tensor          # [NB, N_D]


class SymbolResult(typing.NamedTuple):
    tok: torch.Tensor            # i32[out_size + 1] packed tokens
    done: torch.Tensor           # bool[NL] reached lane_end
    bad: torch.Tensor            # bool[NL] went bad
    ocur: torch.Tensor           # i64[NL] final output cursor


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {
        "decode_symbols_launch": [vp, i64, vp, vp, vp, vp, vp, i64, i64, vp,
                                  vp, vp, vp, vp, vp, i64, i64, i64, i64, vp,
                                  vp, vp, vp, ctypes.c_int, vp]})
    return lib.decode_symbols_launch, cuda_build.raw_stream()


# ------------------------------------------------------------ symbol decode

def _window48(w: torch.Tensor, bp: torch.Tensor) -> torch.Tensor:
    """Stream bits [bp, bp + 48) as int64, LSB first; words are u32 values
    in int64 and bits outside them read 0."""
    W = w.shape[0]
    k = bp >> 5
    sh = bp & 31

    def word(i):
        ok = (i >= 0) & (i < W)
        return torch.where(ok, w[i.clamp(0, max(W - 1, 0))], 0)
    w0, w1, w2 = word(k), word(k + 1), word(k + 2)
    keep = (torch.ones_like(sh) << sh) - 1       # low sh bits of a word
    lo = (w0 >> sh) | ((w1 & keep) << (32 - sh))
    hi = (w1 >> sh) | ((w2 & keep) << (32 - sh))
    return lo | ((hi & 0xFFFF) << 32)


def _slow_decode(cnt, sym, pay, blk, bits, shift):
    """Vectorized RFC 1951 §3.2.2 walk (slow_decode in the source)."""
    nsym = sym.shape[1]
    code = torch.zeros_like(bits)
    first = torch.zeros_like(bits)
    index = torch.zeros_like(bits)
    res = torch.zeros_like(bits)
    found = torch.zeros_like(bits, dtype=torch.bool)
    for ln in range(1, MAX_BITS + 1):
        code = code | (bits & 1)
        bits = bits >> 1
        count = cnt[blk, ln].long()
        hit = ~found & (code - count < first)
        k = index + code - first
        kin = (k >= 0) & (k < nsym)
        s = sym[blk, k.clamp(0, nsym - 1)].long()
        sin = kin & (s >= 0) & (s < nsym)
        val = pay[s.clamp(0, nsym - 1)].long() | (ln << shift)
        res = torch.where(hit, torch.where(sin, val, 0), res)
        found = found | hit
        index = index + count
        first = (first + count) << 1
        code = code << 1
    return res


def _lookup(lut, cnt, sym, pay, blk, bits, shift):
    e = lut[blk, bits & (LUT_SIZE - 1)].long()
    long_ = e == LONG_CODE
    if bool(long_.any()):
        e = torch.where(long_, _slow_decode(cnt, sym, pay, blk, bits, shift),
                        e)
    return e


def decode_symbols_ref(words, bp, ocur, lane_end, lblk, lbad,
                       tables: SymbolTables, max_dist: int, bit_budget: int,
                       out_size: int, max_steps: int) -> SymbolResult:
    """Plain version of the kernel: a loop over steps, vectorized over the
    lanes still active; each step decodes one token per lane by LUT
    gathers. Arguments as for `decode_symbols`."""
    dev = words.device
    w = words.long() & 0xFFFFFFFF
    S = int(out_size)
    live = lblk >= 0
    done = ~live | (ocur >= lane_end)
    bad = lbad.clone()
    bp = bp.clone()
    ocur = ocur.clone()
    tok = torch.zeros(S + 1, dtype=torch.int32, device=dev)
    ll_pay = torch.as_tensor(LL_PAY, device=dev)
    d_pay = torch.as_tensor(D_PAY, device=dev)
    act = torch.nonzero(~done & ~bad).squeeze(1)
    steps = 0
    while act.numel() and steps < max_steps:
        blk = lblk[act].long()
        b = bp[act]
        o = ocur[act]
        win = _window48(w, b)
        e = _lookup(tables.ll_lut, tables.ll_cnt, tables.ll_sym, ll_pay,
                    blk, win, LL_SHIFT)
        cl = (e >> 14) & 0xF
        kind = (e >> 12) & 3
        is_len = kind == 2
        bad_now = (cl == 0) | ((kind != 0) & ~is_len)
        leb = (e >> 9) & 7
        mlen = (e & 0x1FF) + ((win >> cl) & ((1 << leb) - 1))
        w2 = win >> (cl + leb)
        de = _lookup(tables.d_lut, tables.d_cnt, tables.d_sym, d_pay,
                     blk, w2, D_SHIFT)
        dcl = (de >> 20) & 0xF
        deb = (de >> 15) & 0xF
        mdist = (de & 0x7FFF) + ((w2 >> dcl) & ((1 << deb) - 1))
        bad_now |= is_len & ((dcl == 0) | (((de >> 19) & 1) == 1)
                             | (mdist > max_dist))
        o2 = o + torch.where(is_len, mlen, 1)
        b2 = b + torch.where(is_len, cl + leb + dcl + deb, cl)
        bad_now |= (o2 > lane_end[act]) | (b2 > bit_budget)
        emit = ~bad_now
        pack = (torch.where(is_len, mlen | (mdist << 9) | (1 << 26),
                            e & 0x1FF) | (1 << 25)).to(torch.int32)
        wr = emit & (o >= 0) & (o < S)
        tok[o[wr]] = pack[wr]
        ocur[act] = torch.where(emit, o2, o)
        bp[act] = torch.where(emit, b2, b)
        fin = emit & (o2 >= lane_end[act])
        done[act] = fin
        bad[act] = bad_now
        act = act[emit & ~fin]
        steps += 1
    return SymbolResult(tok, done, bad, ocur)


def cta_rounds(lblk, visit, n_blocks: int, threads: int = THREADS):
    """The kernel's schedule, in plain torch: CTA c takes lanes
    [c * threads, (c + 1) * threads) in their own order; each round it
    stages the tables of the TABLE_SETS smallest blocks still pending among
    its visited lanes and decodes those lanes. Returns, per CTA, the list
    of rounds, each a list of (block, lane ids decoded with its tables)."""
    NL = lblk.shape[0]
    key = torch.where(visit & (lblk < n_blocks), lblk.long(), -1).tolist()
    ctas = []
    for c0 in range(0, NL, threads):
        pending = {i: key[i] for i in range(c0, min(NL, c0 + threads))
                   if key[i] >= 0}
        rounds = []
        while pending:
            blocks = sorted(set(pending.values()))[:TABLE_SETS]
            rounds.append([(b, [i for i, k in pending.items() if k == b])
                           for b in blocks])
            pending = {i: k for i, k in pending.items() if k not in blocks}
        ctas.append(rounds)
    return ctas


def _check_decode(words, bp, ocur, lane_end, lblk, lbad, tables):
    dev = words.device
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("words must be 1-D int32 (u32 bit patterns)")
    NL = bp.shape[0]
    for name, t, dt in (("bp", bp, torch.int64), ("ocur", ocur, torch.int64),
                        ("lane_end", lane_end, torch.int64),
                        ("lblk", lblk, torch.int32),
                        ("lbad", lbad, torch.bool)):
        if t.dtype != dt or t.shape != (NL,) or t.device != dev:
            raise ValueError(f"{name} must be {dt}[{NL}] on {dev}")
    NB = tables.ll_lut.shape[0]
    shapes = {"ll_lut": (NB, LUT_SIZE), "d_lut": (NB, LUT_SIZE),
              "ll_cnt": (NB, MAX_BITS + 1), "d_cnt": (NB, MAX_BITS + 1),
              "ll_sym": (NB, N_LL), "d_sym": (NB, N_D)}
    for name, shape in shapes.items():
        t = getattr(tables, name)
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"tables.{name} must be contiguous int32"
                             f"{list(shape)} on {dev}")
    if NL >= 2**31:
        raise ValueError("too many lanes for the kernel's int32 lane ids")


def decode_symbols(words, bp, ocur, lane_end, lblk, lbad,
                   tables: SymbolTables, max_dist: int, bit_budget: int,
                   out_size: int, max_steps: int) -> SymbolResult:
    """Decode every lane's tokens into tok[out_size + 1].

    words: i32[CW] stream words (u32 bit patterns). Per lane (NL): bp, ocur
    and lane_end (int64): start bit, output cursor and end; lblk (int32):
    coding block, -1 for a dead lane; lbad (bool): bad from the start. A
    lane is done from the start when it is dead or ocur >= lane_end; else
    it decodes at most max_steps tokens. A CUDA tensor goes through the
    kernel (or this raises); a CPU tensor through `decode_symbols_ref`."""
    _check_decode(words, bp, ocur, lane_end, lblk, lbad, tables)
    dev = words.device
    if dev.type == "cpu":
        return decode_symbols_ref(words, bp, ocur, lane_end, lblk, lbad,
                                  tables, max_dist, bit_budget, out_size,
                                  max_steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S = int(out_size)
    NL = bp.shape[0]
    tok = torch.zeros(S + 1, dtype=torch.int32, device=dev)
    done = torch.empty(NL, dtype=torch.bool, device=dev)
    bad = torch.empty(NL, dtype=torch.bool, device=dev)
    ocur_out = torch.empty(NL, dtype=torch.int64, device=dev)
    if NL == 0:
        return SymbolResult(tok, done, bad, ocur_out)
    words, bp, ocur, lane_end, lblk, lbad = (
        x.contiguous() for x in (words, bp, ocur, lane_end, lblk, lbad))
    # the kernel stages each table row with one bulk copy: 16-byte aligned
    t = [x if x.data_ptr() % 16 == 0 else x.clone() for x in tables]
    launch, stream = _bind()
    rc = launch(words.data_ptr(), words.shape[0], bp.data_ptr(),
                ocur.data_ptr(), lane_end.data_ptr(), lblk.data_ptr(),
                lbad.data_ptr(), NL, tables.ll_lut.shape[0],
                *(x.data_ptr() for x in t), int(max_dist), int(bit_budget), S,
                int(max_steps), tok.data_ptr(), done.data_ptr(),
                bad.data_ptr(), ocur_out.data_ptr(), dev.index,
                stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"decode_symbols launch failed: cudaError {rc}")
    decode_symbols.launches += 1
    return SymbolResult(tok, done, bad, ocur_out)


decode_symbols.launches = 0
