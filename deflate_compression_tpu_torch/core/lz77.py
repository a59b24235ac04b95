"""LZ77 match finding and parse (counterpart of
deflate_compression_tpu/core/lz77.py).

`tokenize` is two kernels on the card, each with its plain version for CPU
tensors:
  1. `find_matches` (ops/find_matches.py): hash every 3-byte prefix (16-bit
     multiplicative hash, wrapping mod 2^32); walk each position's hash
     chain (16-bit back links from one stable sort by hash) over its K
     nearest same-hash predecessors within 32 KB, scored on an 11-byte
     prefix (the longest wins, then the nearest); rescore the winner to 35
     bytes;
  2. `lz_parse` (ops/lz_parse.py): constant runs found exactly, matches
     chained to 258 bytes, tokens clamped at 32 KB tile boundaries,
     two-step lazy, then the greedy parse: the chosen token starts are the
     orbit of 0 under next[i] = i + len[i].
Between the two, tokenize hands over (length, dist) packed in one int32 a
position (`find_matches_packed`, `lz_parse_packed`).

The JAX package picks the same winner in both of its branches: its fold
preselect (S <= 2^20, a packed key with a 20-bit candidate field) and its
sorted-order branch for larger shards (a strict `>` over k = 1..K, the same
rescore).
"""
from __future__ import annotations

import torch

from ..ops.find_matches import (  # noqa: F401
    find_matches, find_matches_packed, find_matches_ref)
from ..ops.lz_parse import (  # noqa: F401
    greedy_parse, lz_parse, lz_parse_packed, lz_parse_ref)


def tokenize(data: torch.Tensor, valid_len: int, num_candidates: int = 32,
             lazy: bool = True):
    """Full LZ77 stage for one shard.

    data: u8[S] shard bytes (the tail past valid_len is padding).
    Returns dict of per-position tensors: chosen (bool, a token starts
    here), length and dist (int64, 0 for a literal). Padding positions are
    never chosen. On the card this launches find_matches and lz_parse once
    each."""
    return lz_parse_packed(data, find_matches_packed(data, num_candidates),
                           valid_len, lazy)
