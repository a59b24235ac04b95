"""Canonical Huffman machinery (counterpart of
deflate_compression_tpu/core/huffman.py).

Alphabets are batched: every function takes a (B, n) tensor of B
independent alphabets where the JAX package vmaps over them. Determinism
rules kept from the reference: the stable argsort (frequency ascending,
symbol ascending) and the leaf-before-package tie rule of package-merge.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.histogram import tile_histogram

INF_W = 1 << 28


def histogram(symbols: torch.Tensor, num_classes: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked bincount of all symbols, length `num_classes` (int64)."""
    sym = symbols.long()
    if mask is not None:
        sym = torch.where(mask, sym, num_classes)
    sym = torch.where((sym >= 0) & (sym < num_classes), sym, num_classes)
    return torch.bincount(sym.reshape(-1),
                          minlength=num_classes + 1)[:num_classes]


def histogram_rows(sym: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-row histogram (M, L) -> (M, num_classes) through the
    tile_histogram kernel, one launch and counts in sym's type (int64 from
    the encoder); symbols outside [0, num_classes) drop out. Replaces the
    JAX one-hot matmul `histogram_rows_matmul`."""
    return tile_histogram(sym.contiguous(), num_classes)


def _package_merge_lengths(leaf_w: torch.Tensor, k: torch.Tensor,
                           max_bits: int) -> torch.Tensor:
    """Optimal length-limited code lengths by dense package-merge.

    leaf_w: (B, n) ascending active leaf weights, INF-padded.
    k: (B,) active counts. Returns (B, n): length of the j-th sorted leaf
    (0 for j >= k). Level list P_l = merge(leaves, pairs(P_{l-1})) is kept
    as a sorted weight array plus its leaf-count prefix sum; a top-down
    pass m_{l-1} = 2 * (#packages among the first m_l of P_l) gives the
    chosen-leaf count per level.
    """
    B, n = leaf_w.shape
    dev = leaf_w.device
    m2 = 2 * n
    leaves2 = torch.cat([leaf_w, torch.full((B, n), INF_W, dtype=torch.int64,
                                            device=dev)], dim=1)
    zero_col = torch.zeros((B, 1), dtype=torch.int64, device=dev)

    def cumleaf(w, f):
        is_leaf = f * (w < INF_W)
        return torch.cat([zero_col, torch.cumsum(is_leaf, dim=1)], dim=1)

    flag1 = torch.cat([torch.ones((B, n), dtype=torch.int64, device=dev),
                       torch.zeros((B, n), dtype=torch.int64, device=dev)],
                      dim=1)
    levels = [cumleaf(leaves2, flag1)]
    lv = leaves2[:, :n].contiguous()
    jn = torch.arange(n, device=dev).expand(B, n)
    w = leaves2
    for _ in range(max_bits - 1):
        pw = w.view(B, n, 2).sum(dim=2).clamp(max=INF_W).contiguous()
        # Both inputs are sorted, so the merge is a rank computation.
        # Ties: leaf before package (rank_l counts packages strictly below
        # the leaf, rank_p counts leaves at or below the package).
        rank_l = jn + torch.searchsorted(pw, lv, right=False)
        rank_p = jn + torch.searchsorted(lv, pw, right=True)
        w2 = torch.full((B, m2), INF_W, dtype=torch.int64, device=dev)
        w2.scatter_(1, rank_l, lv)
        w2.scatter_(1, rank_p, pw)
        f2 = torch.zeros((B, m2), dtype=torch.int64, device=dev)
        f2.scatter_(1, rank_l, torch.ones_like(lv))
        levels.append(cumleaf(w2, f2))
        w = w2

    # top-down: choose the first 2k-2 items at the deepest level
    m = (2 * k - 2).clamp(min=0).unsqueeze(1)
    nleafs = [None] * max_bits
    for lvl in range(max_bits - 1, -1, -1):
        nleaf = torch.gather(levels[lvl], 1, m.clamp(0, m2))
        nleafs[lvl] = nleaf
        m = 2 * (m - nleaf)
    j = torch.arange(n, device=dev).unsqueeze(0)
    length = torch.zeros((B, n), dtype=torch.int64, device=dev)
    for nleaf in nleafs:
        length = length + (j < nleaf).long()
    return torch.where(j < k.unsqueeze(1), length, 0)


def huffman_code_lengths(freqs: torch.Tensor,
                         max_bits: int = 15) -> torch.Tensor:
    """Optimal length-limited code lengths for each row of freqs (B, n).

    Among active symbols, lower frequency means a longer code, ties by
    symbol index. One active symbol gets length 1."""
    freqs = freqs.long()
    B, n = freqs.shape
    active = freqs > 0
    k = active.sum(dim=1)
    key = torch.where(active, freqs, INF_W)
    order = torch.argsort(key, dim=1, stable=True)
    leaf_w = torch.gather(key, 1, order)
    length_sorted = _package_merge_lengths(leaf_w, k, max_bits)
    j = torch.arange(n, device=freqs.device).unsqueeze(0)
    length_sorted = torch.where((k == 1).unsqueeze(1), (j == 0).long(),
                                length_sorted)
    lengths = torch.zeros_like(length_sorted).scatter_(1, order,
                                                       length_sorted)
    return torch.where(active, lengths, 0)


def canonical_codes(lengths: torch.Tensor, max_bits: int = 15) -> torch.Tensor:
    """RFC 1951 §3.2.2 canonical codes (MSB-first, not yet bit-reversed)
    for each row of lengths (B, n)."""
    lengths = lengths.long()
    onehot = (lengths.unsqueeze(2) == torch.arange(
        max_bits + 1, device=lengths.device)).long()        # (B, n, L+1)
    bl_count = onehot.sum(dim=1)
    bl_count[:, 0] = 0
    code = torch.zeros_like(bl_count[:, 0])
    ncs = [code]
    for l in range(1, max_bits + 1):
        code = (code + bl_count[:, l - 1]) << 1
        ncs.append(code)
    next_code = torch.stack(ncs, dim=1)                     # (B, L+1)
    # rank among symbols of the same length, in symbol order
    ranks = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.gather(ranks, 2, lengths.unsqueeze(2)).squeeze(2)
    codes = torch.gather(next_code, 1, lengths) + rank
    return torch.where(lengths > 0, codes, 0)


def canonical_codes_np(lengths: np.ndarray, max_bits: int = 15) -> np.ndarray:
    """Host (numpy) canonical codes for one alphabet."""
    lengths = np.asarray(lengths, dtype=np.int64)
    bl_count = np.bincount(lengths, minlength=max_bits + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_bits + 1, dtype=np.int64)
    code = 0
    for l in range(1, max_bits + 1):
        code = (code + bl_count[l - 1]) << 1
        next_code[l] = code
    codes = np.zeros(lengths.shape[0], dtype=np.int64)
    cnt = np.zeros(max_bits + 1, dtype=np.int64)
    for s, l in enumerate(lengths):
        if l > 0:
            codes[s] = next_code[l] + cnt[l]
            cnt[l] += 1
    return codes.astype(np.uint32)


def decode_lut_np(lengths: np.ndarray, max_bits: int = 15):
    """Host flat decode LUT (copy of the JAX package's decode_lut_np):
    (sym_lut, len_lut) of size 2^max_bits, indexed by the next max_bits
    stream bits (LSB-first peek). Unused patterns get len 0. Raises
    ValueError on over-subscribed code lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    size = 1 << max_bits
    sym_lut = np.full(size, -1, dtype=np.int32)
    len_lut = np.zeros(size, dtype=np.int32)
    codes = canonical_codes_np(lengths, max_bits)
    kraft = int(np.sum((lengths > 0)
                       * (1 << (max_bits - np.minimum(lengths, max_bits)))))
    if kraft > size:
        raise ValueError("over-subscribed Huffman code lengths")
    for s, l in enumerate(lengths):
        l = int(l)
        if l == 0:
            continue
        c = int(codes[s])
        r = 0
        for _ in range(l):
            r = (r << 1) | (c & 1)
            c >>= 1
        idx = np.arange(r, size, 1 << l)
        sym_lut[idx] = s
        len_lut[idx] = l
    return sym_lut, len_lut
