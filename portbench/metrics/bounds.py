"""Byte counts and roofline shares of the kernels the benchmark reads.

A kernel's least time is the bytes its stage must move, each input read
once and each output written once, over the HBM peak (`peaks.py`); its
share is that least time over its device time in the trace, in per cent.
The counts are those of the kernel table in PERF.md:

- find_matches: the shard read once and one packed 32-bit match a
  position written once, 5 B a position;
- copy_sources: 4 B of token read and 1 B written a position of the flat
  decode, and each stored byte read once;
- pack_words: counted on the call's own arguments, as chip_smoke.py's
  `pack_bytes` counts it (18 B a position of the tiles whose block has
  Huffman codes, a stored block's bytes, the used blocks' rows, header
  items and code words, then the words, the layout and 24 B a decode
  entry written).
"""
from __future__ import annotations

import numpy as np

from portbench.peaks import HBM_BYTES_PER_S

TILE = 32768                     # the encoder's tile (window) in bytes


def least_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def roofline_pct(nbytes: float, device_s: float) -> float:
    return 100.0 * least_s(nbytes) / device_s


def find_matches_bytes(S: int) -> int:
    return 5 * S


def copy_sources_bytes(positions: int, stored: int) -> int:
    return 5 * positions + stored


def pack_words_bytes(S: int, nw: int, blk, huff, sto, blen, ll, d,
                     nbs) -> int:
    """pack_words' bytes on one call's arguments: blk[NB] each tile's
    block, huff/sto/blen[NB] per block, ll/d[NB, n + 1] table words
    (code length << 16 | reversed code, a zero column last), nbs[NB, H]
    header item widths, nw the words written."""
    NB = S // TILE
    nbu = int(blk.max()) + 1                  # the blocks used
    huff, sto, blen, nbs = huff[:nbu], sto[:nbu], blen[:nbu], nbs[:nbu]
    tabs = np.concatenate([ll[:nbu][huff][:, :-1], d[:nbu][huff][:, :-1]],
                          1)
    reads = (18 * TILE * int(huff[blk].sum())
             + int(np.minimum(blen[sto], TILE).sum())
             + 8 * NB + nbu * (8 + 1 + 1 + 8 + 8 * nbs.shape[1])
             + 8 * int((nbs > 0).sum()) + 8 * int((tabs >> 16 > 0).sum())
             + 8)
    return reads + 8 * (nw + 3 * NB + 3) + 24 * (S // 64)
