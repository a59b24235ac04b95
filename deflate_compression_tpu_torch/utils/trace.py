"""Per-symbol encoder telemetry, the reference's stats format A
(counterpart of deflate_compression_tpu/utils/trace.py, with the same
records and CSV).

The CSV header is `bytes, codes, ebits, ll_aht, d_aht, ratio`:

  bytes   cumulative input bytes consumed
  codes   bits to emit the RLE'd code-length sequence through the optimal
          code-length-alphabet tree
  ebits   structural header bits: HLIT+HDIST+HCLEN fields, the 3-bit HCLEN
          slots, and the extra bits of RLE symbols 16/17/18
  ll_aht  running adaptive-Huffman score of the lit/len symbol stream
          (sum of weight x depth == optimal bits so far)
  d_aht   the same for the distance symbol stream
  ratio   (codes + ebits + ll_aht + d_aht) / bytes, bits per input byte

The records come from the encoder's real token stream: the input is
tokenized by core/lz77.tokenize on the card (or the CPU when asked), and
every chosen token is pushed through two Vitter AHTs (core/aht.py) plus
the exact dynamic-header cost decomposition, on the host.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from ..core.aht import AdaptiveHuffmanTree
from ..device import pick_device
from ..format import constants as C

CSV_HEADER = "bytes, codes, ebits, ll_aht, d_aht, ratio"


def _dist_code(dist: int) -> int:
    if dist <= 256:
        return int(C.DIST_TO_CODE_LO[dist - 1])
    return int(C.DIST_TO_CODE_HI[(dist - 1) >> 7])


def _clen_tree_cost(freqs: np.ndarray) -> int:
    """Optimal Σ weight·depth over the 19-symbol code-length alphabet
    (reference h_tree_builder_build + _score, src/h_tree.c:242-302)."""
    live = [int(w) for w in freqs if w > 0]
    if len(live) <= 1:
        # a single live symbol still needs 1 bit per occurrence in RFC
        # terms; the reference's two-queue builder gives it depth 1 only
        # when a second node exists — mirror the degenerate case as depth 1
        return sum(live)
    heapq.heapify(live)
    cost = 0
    while len(live) > 1:
        a, b = heapq.heappop(live), heapq.heappop(live)
        cost += a + b
        heapq.heappush(live, a + b)
    return cost


def _header_cost(ll_depths: np.ndarray, d_depths: np.ndarray):
    """(codes, ebits) of the dynamic-block header for the given code-length
    vectors — the RLE walk of RFC 1951 §3.2.7 including the lit/len→dist
    carry-over (reference h_tree_d_lens, src/h_tree.c:75-148).

    Returns the exact cost the encoder would pay to describe these two
    trees right now: ebits = 14 header bits + 3·(HCLEN+4) slot bits +
    extra bits of 16/17/18; codes = Σ clen_freq·depth of the optimal
    code-length tree.
    """
    hlit = 257
    for i in range(C.NUM_LITLEN - 1, 256, -1):
        if ll_depths[i] != 0:
            hlit = i + 1
            break
    hdist = 1
    for i in range(C.NUM_DIST - 1, 0, -1):
        if d_depths[i] != 0:
            hdist = i + 1
            break
    seq = np.concatenate([ll_depths[:hlit], d_depths[:hdist]])
    freqs = np.zeros(19, dtype=np.int64)
    ebits = 5 + 5 + 4
    i = 0
    n = len(seq)
    while i < n:
        d = seq[i]
        j = i + 1
        while j < n and seq[j] == d:
            j += 1
        run = j - i
        if d == 0 and run >= 3:
            while run >= 11:
                take = min(run, 138)
                freqs[18] += 1
                ebits += 7
                run -= take
            if run >= 3:
                freqs[17] += 1
                ebits += 3
                run = 0
            freqs[0] += run          # 1-2 stragglers emitted verbatim
        else:
            freqs[d] += 1
            run -= 1
            while run >= 3:
                take = min(run, 6)
                freqs[16] += 1
                ebits += 2
                run -= take
            freqs[d] += run
        i = j
    # HCLEN: last transmitted-order position with nonzero frequency
    nz = [int(C.CLEN_ORDER_INV[s]) for s in range(19) if freqs[s] > 0]
    hclen_slots = max(4, (max(nz) + 1) if nz else 4)
    ebits += 3 * hclen_slots
    return _clen_tree_cost(freqs), ebits


def per_symbol_records(raw: bytes, num_candidates: int = 32,
                       lazy: bool = True, stride: int = 1,
                       header_stride: int = 1, device=None):
    """Yield format-A records from the production token stream.

    The whole input is tokenized as one shard of its own length by
    core/lz77.tokenize on `device` (the CUDA card unless "cpu" is asked
    for); the AHTs and the header costing run on the host.

    stride: emit every stride-th record (the full header costing is
      O(alphabet) per symbol, like the reference's per-symbol qsort+build;
      stride>1 samples it for long inputs). The final symbol is always
      emitted.
    header_stride: recompute (codes, ebits) every this-many records;
      between recomputations the last value is carried (the AHT scores are
      always exact).
    """
    from ..core.lz77 import tokenize

    if not raw:
        return
    data_np = np.frombuffer(raw, np.uint8)
    data = torch.from_numpy(data_np.copy()).to(pick_device(device))
    toks = tokenize(data, len(raw), num_candidates=num_candidates, lazy=lazy)
    chosen = toks["chosen"].cpu().numpy()
    length = toks["length"].cpu().numpy()
    dist = toks["dist"].cpu().numpy()

    ll_aht = AdaptiveHuffmanTree(C.NUM_LITLEN)
    d_aht = AdaptiveHuffmanTree(C.NUM_DIST)
    ll_aht.insert(C.EOB)        # pre-seed EOB (reference deflate_compress.c:234)

    positions = np.nonzero(chosen)[0]
    n_tok = len(positions)
    consumed = 0
    codes = ebits = 0
    emitted = 0
    for t, i in enumerate(positions):
        ln = int(length[i])
        if ln >= C.MIN_MATCH:
            # NOTE: like the reference's ratio, the AHT columns count code
            # bits only — len/dist EXTRA bits are not part of format A
            # (deflate_ext.h:29-30 defines rate from tree+ll+d bits alone)
            ll_aht.insert(int(C.LEN_TO_CODE[ln - 3]))
            d_aht.insert(_dist_code(int(dist[i])))
            consumed += ln
        else:
            ll_aht.insert(int(data_np[i]))
            consumed += 1
        last = t == n_tok - 1
        if t % stride and not last:
            continue
        if emitted % header_stride == 0 or last:
            ll_depths = np.zeros(C.NUM_LITLEN, dtype=np.int32)
            for s, dd in ll_aht.depths().items():
                ll_depths[s] = dd
            d_depths = np.zeros(C.NUM_DIST, dtype=np.int32)
            for s, dd in d_aht.depths().items():
                d_depths[s] = dd
            codes, ebits = _header_cost(ll_depths, d_depths)
        emitted += 1
        total = codes + ebits + ll_aht.score + d_aht.score
        yield (consumed, codes, ebits, ll_aht.score, d_aht.score,
               total / consumed)


def per_symbol_trace_csv(raw: bytes, **kw) -> str:
    """Format-A CSV, diffable against the reference's results/results.txt
    (keywords as per_symbol_records, `device` included)."""
    lines = [CSV_HEADER]
    for b, c, e, ll, d, r in per_symbol_records(raw, **kw):
        lines.append(f"{b}, {c}, {e}, {ll}, {d}, {r:.6f}")
    return "\n".join(lines) + "\n"
