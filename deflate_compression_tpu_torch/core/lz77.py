"""LZ77 match finding and parse (counterpart of
deflate_compression_tpu/core/lz77.py, fold-preselect branch).

  1. hash every 3-byte prefix (16-bit multiplicative hash, wrapping mod
     2^32);
  2. one stable argsort by hash: a position's K nearest earlier same-hash
     positions are its K sorted predecessors, scored on an 11-byte prefix
     with shifted-slice compares; the longest prefix wins, then the nearest
     (smallest k), through the packed int64 key
     (nbytes+1) << 40 | (K-k) << 32 | cand;
  3. the winner is rescored exactly to 35 bytes in position order;
  4. constant runs are found exactly with two scans, matches chain to 258
     bytes, tokens are clamped at 32 KB tile boundaries, two-step lazy;
  5. greedy parse: the chosen token starts are the orbit of 0 under
     next[i] = i + len[i], found by pointer doubling.

All values are int64 tensors (u32 values carried as in core/u32.py). The
key's 32-bit candidate field serves any shard size, so one code path picks
the winner the JAX package picks in both of its branches: its fold
preselect (a 20-bit candidate field, S <= 2^20) and its sorted-order branch
for larger shards (a strict `>` over k = 1..K, the same rescore).
"""
from __future__ import annotations

import math

import torch

from ..format import constants as C
from . import scans
from .u32 import mul32

HASH_BITS = 16
HASH_MUL = 2654435761
_CAND_BITS = 32                 # candidate field of the packed key
_K_BITS = 8                     # (K - k) field: num_candidates < 256


def _shift_down(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """y[i] = x[i-k], the first k filled."""
    k = min(k, x.shape[0])
    return torch.cat([torch.full((k,), fill, dtype=x.dtype, device=x.device),
                      x[:-k]])


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[i] = x[i+k], the last k zero."""
    k = min(k, x.shape[0])
    return torch.cat([x[k:], torch.zeros(k, dtype=x.dtype, device=x.device)])


def _words4(d: torch.Tensor) -> torch.Tensor:
    """w4[i] = d[i..i+3] as an LSB-first u32 (tail zero-padded)."""
    return (d | (_shift_up(d, 1) << 8) | (_shift_up(d, 2) << 16)
            | (_shift_up(d, 3) << 24))


def _tail_bytes(diff: torch.Tensor) -> torch.Tensor:
    """Leading equal bytes (0-3) of an LSB-first u32 word diff."""
    return torch.where((diff & 0xFF) != 0, 0,
                       torch.where((diff & 0xFFFF) != 0, 1,
                                   torch.where((diff & 0xFFFFFF) != 0, 2, 3)))


def find_matches(data: torch.Tensor, num_candidates: int = 32):
    """Best match per position: (length, dist), int64[S]; length 0 where
    no usable match. Lengths are capped at 35 (8 payload words + tail)."""
    S = data.shape[0]
    K = num_candidates
    if not 1 <= K < (1 << _K_BITS):
        raise ValueError(f"num_candidates must be in [1, {(1 << _K_BITS) - 1}]")
    dev = data.device
    nb_shift = _CAND_BITS + _K_BITS
    PW = 8
    pos = torch.arange(S, device=dev)
    d = data.long()

    tri = d | (_shift_up(d, 1) << 8) | (_shift_up(d, 2) << 16)
    h = mul32(tri, HASH_MUL) >> (32 - HASH_BITS)

    w4 = _words4(d)
    # payload table P[i, t] = w4[i + 4t], t = 0..PW
    P = torch.stack([w4] + [_shift_up(w4, 4 * t) for t in range(1, PW + 1)],
                    dim=1)

    order = torch.argsort(h, stable=True)
    hs = h[order]
    ps = order
    pr = P[order, :3]                            # sorted 3-word rows
    pw0, pw1, pw2 = pr[:, 0], pr[:, 1], pr[:, 2]

    run_ne = torch.ones(S, dtype=torch.bool, device=dev)
    run_ne[1:] = hs[1:] != hs[:-1]
    seg_start = scans.cummax(torch.where(run_ne, pos, -1))
    dseg = pos - seg_start

    mk = torch.full((S,), -1, dtype=torch.int64, device=dev)
    for k in range(1, K + 1):
        cnd = _shift_down(ps, k, -1)
        ok = (k <= dseg) & (cnd >= 0) & ((ps - cnd) <= C.WINDOW_SIZE)
        d0 = pw0 ^ _shift_down(pw0, k, 0)
        d1 = pw1 ^ _shift_down(pw1, k, 0)
        dl = pw2 ^ _shift_down(pw2, k, 0)
        e0 = d0 == 0
        e1 = d1 == 0
        nw = e0.long() + (e0 & e1).long()
        fd = torch.where(~e0, d0, torch.where(~e1, d1, dl))
        nb = 4 * nw + _tail_bytes(fd)
        key = torch.where(ok, ((nb + 1) << nb_shift)
                          | ((K - k) << _CAND_BITS) | cnd, -1)
        mk = torch.maximum(mk, key)
    best_cand = torch.where(mk >= (1 << nb_shift),
                            mk & ((1 << _CAND_BITS) - 1), -1)

    # back to position order (ps is a permutation)
    cand_p = torch.empty_like(best_cand)
    cand_p[ps] = best_cand
    valid = cand_p >= 0
    cand_c = cand_p.clamp(min=0)
    # exact rescore of the winner in position order
    fr = P[cand_c]
    run = torch.ones(S, dtype=torch.int64, device=dev)
    nw = torch.zeros(S, dtype=torch.int64, device=dev)
    first_diff = torch.zeros(S, dtype=torch.int64, device=dev)
    for t in range(PW):
        diff = P[:, t] ^ fr[:, t]
        hit = (run > 0) & (diff != 0)
        first_diff = torch.where(hit, diff, first_diff)
        eq = (diff == 0).long()
        nw = nw + run * eq
        run = run * eq
    dlast = P[:, PW] ^ fr[:, PW]
    first_diff = torch.where(run > 0, dlast, first_diff)
    length = torch.where(valid, 4 * nw + _tail_bytes(first_diff), -1)

    length = length.clamp(max=C.MAX_MATCH)
    length = torch.minimum(length, S - pos)       # padding equality is fake
    length = torch.where(valid, length, 0)
    length = torch.where(length >= C.MIN_MATCH, length, 0)
    dist = torch.where(length > 0, pos - cand_c, 0)
    return length, dist


def greedy_parse(token_len: torch.Tensor) -> torch.Tensor:
    """Token starts: the orbit of 0 under next[i] = i + token_len[i],
    by pointer doubling (ceil(log2 S) rounds)."""
    S = token_len.shape[0]
    dev = token_len.device
    nxt = torch.clamp(torch.arange(S, device=dev) + token_len, max=S)
    jump = torch.cat([nxt, torch.tensor([S], device=dev)])   # S absorbs
    chosen = torch.zeros(S + 1, dtype=torch.bool, device=dev)
    chosen[0] = True
    for _ in range(max(1, math.ceil(math.log2(max(S, 2))))):
        tgt = torch.where(chosen, jump, S)
        chosen = chosen.index_fill(0, tgt, True)
        jump = jump[jump]
    return chosen[:S]


def tokenize(data: torch.Tensor, valid_len: int, num_candidates: int = 32,
             lazy: bool = True):
    """Full LZ77 stage for one shard.

    data: u8[S] shard bytes (the tail past valid_len is padding).
    Returns dict of per-position tensors: chosen (bool, a token starts
    here), length and dist (int64, 0 for a literal). Padding positions are
    never chosen."""
    S = data.shape[0]
    dev = data.device
    pos = torch.arange(S, device=dev)
    length, dist = find_matches(data, num_candidates)

    # constant runs (period 1): exact dist-1 matches
    d = data.long()
    neq = d != _shift_down(d, 1, -1)
    nxt_start = torch.where(neq, pos, S)
    after = torch.cat([nxt_start[1:], torch.tensor([S], device=dev)])
    run_end = scans.cummin(after.flip(0)).flip(0)
    run_len = torch.where(~neq, torch.clamp(run_end - pos, max=C.MAX_MATCH), 0)
    better = run_len > length
    length = torch.where(better, run_len, length)
    dist = torch.where(better, 1, dist)

    # chain extension to MAX_MATCH: a match certified through i+s-1 at
    # dist d continues with the match at i+s if that has the same d
    for s in (32, 64, 128):
        if s >= S:
            break
        l_s = _shift_up(length, s)
        d_s = _shift_up(dist, s)
        can = (length >= s + 3) & (d_s == dist) & (dist > 0)
        length = torch.where(can, torch.maximum(length, s + l_s), length)
    length = length.clamp(max=C.MAX_MATCH)

    # clamp to the valid region and to tile boundaries: a token never
    # extends past a 32 KB tile boundary
    length = torch.minimum(length, (valid_len - pos).clamp(min=0))
    length = torch.minimum(length, C.WINDOW_SIZE - (pos % C.WINDOW_SIZE))
    length = torch.where(length >= C.MIN_MATCH, length, 0)

    if lazy:
        # defer to i+1 if it has a strictly longer match; two-step: also
        # to i+2 if its match pays for the extra literal
        demote = (length > 0) & ((_shift_up(length, 1) > length)
                                 | (_shift_up(length, 2) > length + 1))
        length = torch.where(demote, 0, length)
        dist = torch.where(demote, 0, dist)

    token_len = torch.where(length >= C.MIN_MATCH, length, 1)
    chosen = greedy_parse(token_len) & (pos < valid_len)
    return {"chosen": chosen, "length": length, "dist": dist}
