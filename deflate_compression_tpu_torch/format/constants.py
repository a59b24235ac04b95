"""RFC 1951 / RFC 1950 format constants, as numpy tables.

The port's own copy of the DEFLATE alphabets and closed-form code mappings
(the same values as deflate_compression_tpu/format/constants.py, which the
port does not import). Dense tables, so the device stages are gathers.
"""
from __future__ import annotations

import numpy as np

# Alphabet sizes (RFC 1951 §3.2.5-3.2.7)
MAX_MATCH = 258
MIN_MATCH = 3
WINDOW_SIZE = 32768
NUM_LITLEN = 286          # 0-255 literals, 256 EOB, 257-285 lengths
NUM_DIST = 30
NUM_CLEN = 19             # code-length alphabet
MAX_CODE_BITS = 15
MAX_CLEN_BITS = 7
EOB = 256

# Length codes 257..285 (RFC 1951 §3.2.5 Table 1): base length and extra
# bits of code 257 + i
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int32)


def _length_tables():
    """Match length 3..258 -> length code and extra-bit value, indexed by
    length - 3. Code 285 is exactly 258."""
    code = np.zeros(256, dtype=np.int32)
    extra = np.zeros(256, dtype=np.int32)
    for c in range(29):
        lo = 258 if c == 28 else int(LENGTH_BASE[c])
        hi = 258 if c == 28 else min(int(LENGTH_BASE[c + 1]) - 1, 257)
        for ln in range(lo, hi + 1):
            code[ln - 3] = 257 + c
            extra[ln - 3] = ln - LENGTH_BASE[c]
    return code, extra


LEN_TO_CODE, LEN_TO_EXTRA_VAL = _length_tables()

# Distance codes 0..29 (RFC 1951 §3.2.5 Table 2)
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
     12289, 16385, 24577],
    dtype=np.int32)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32)


def _dist_tables():
    """Distance -> code as in zlib: DIST_TO_CODE_LO[dist - 1] for dist up
    to 256, DIST_TO_CODE_HI[(dist - 1) >> 7] above."""
    lo_t = np.zeros(256, dtype=np.int32)
    hi_t = np.zeros(256, dtype=np.int32)
    for c in range(30):
        hi = int(DIST_BASE[c + 1]) - 1 if c < 29 else 32768
        for d in range(int(DIST_BASE[c]), hi + 1):
            if d <= 256:
                lo_t[d - 1] = c
            else:
                hi_t[(d - 1) >> 7] = c
    return lo_t, hi_t


DIST_TO_CODE_LO, DIST_TO_CODE_HI = _dist_tables()

# Code-length alphabet (RFC 1951 §3.2.7): the order in which the HCLEN code
# lengths are sent, and its inverse
CLEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32)
CLEN_ORDER_INV = np.zeros(19, dtype=np.int32)
CLEN_ORDER_INV[CLEN_ORDER] = np.arange(19, dtype=np.int32)

# Extra bits of code-length symbols 16/17/18 and their repeat bases
CLEN_EXTRA = np.zeros(19, dtype=np.int32)
CLEN_EXTRA[16], CLEN_EXTRA[17], CLEN_EXTRA[18] = 2, 3, 7
CLEN_REPEAT_BASE = np.zeros(19, dtype=np.int32)
CLEN_REPEAT_BASE[16], CLEN_REPEAT_BASE[17], CLEN_REPEAT_BASE[18] = 3, 3, 11

# Fixed (BTYPE=1) Huffman code lengths (RFC 1951 §3.2.6); litlen 286/287
# and dist 30/31 are defined but never used
FIXED_LITLEN_LENGTHS = np.concatenate([
    np.full(144, 8), np.full(112, 9), np.full(24, 7), np.full(8, 8),
]).astype(np.int32)
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)

# Block types
BTYPE_STORED = 0
BTYPE_FIXED = 1
BTYPE_DYNAMIC = 2

# zlib container (RFC 1950)
ZLIB_CM_DEFLATE = 8
ADLER_MOD = 65521

# gzip container (RFC 1952)
GZIP_MAGIC = b"\x1f\x8b"
