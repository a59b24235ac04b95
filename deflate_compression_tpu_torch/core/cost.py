"""Adaptive block splitting from tile histograms (counterpart of
deflate_compression_tpu/core/cost.py).

The cost of coding tiles [i, j) as one dynamic block is estimated as
sum f*log2(n/f) + exact extra bits + a tree-description estimate, and a DP
over tile boundaries (merge runs of at most `max_merge` tiles) picks the
segmentation. This is the encoder's one float stage: it stays in float32
with the JAX package's expression order, since a changed rounding can
flip a near-tie split.
"""
from __future__ import annotations

import torch

from ..format import constants as C

_TREE_FIXED = 17.0 + 3 * 15
_TREE_PER_SYM = 5.5
_BIG = 3.4e38


def segment_costs(ll_freq_micro: torch.Tensor, d_freq_micro: torch.Tensor,
                  max_merge: int, tile_bytes: torch.Tensor) -> torch.Tensor:
    """f32[M, max_merge]: estimated bits of the block of tiles
    [max(j-k, 0), j) for j = 1..M and k = 1..max_merge; column 0 (single
    tiles) takes the stored price when that is lower."""
    M = ll_freq_micro.shape[0]
    dev = ll_freq_micro.device
    f32 = torch.float32
    len_extra = torch.as_tensor(C.LENGTH_EXTRA, dtype=f32, device=dev)
    dist_extra = torch.as_tensor(C.DIST_EXTRA, dtype=f32, device=dev)

    llf = ll_freq_micro.to(f32)
    df = d_freq_micro.to(f32)
    cum_ll = torch.cat([torch.zeros((1, llf.shape[1]), dtype=f32, device=dev),
                        torch.cumsum(llf, dim=0)], dim=0)
    cum_d = torch.cat([torch.zeros((1, df.shape[1]), dtype=f32, device=dev),
                       torch.cumsum(df, dim=0)], dim=0)

    ks = torch.arange(1, max_merge + 1, device=dev)
    js = torch.arange(1, M + 1, device=dev)
    jj = js.unsqueeze(1).expand(M, max_merge)
    ii = (jj - ks.unsqueeze(0)).clamp(min=0)
    fll = cum_ll[jj] - cum_ll[ii]                     # (M, mm, 286)
    fd = cum_d[jj] - cum_d[ii]                        # (M, mm, 30)
    nll = fll.sum(dim=2) + 1.0                        # + EOB
    nd = fd.sum(dim=2).clamp(min=1.0)
    h_ll = torch.where(fll > 0, fll * (torch.log2(nll).unsqueeze(2)
                                       - torch.log2(fll.clamp(min=1e-9))),
                       0.0).sum(dim=2)
    h_d = torch.where(fd > 0, fd * (torch.log2(nd).unsqueeze(2)
                                    - torch.log2(fd.clamp(min=1e-9))),
                      0.0).sum(dim=2)
    extra = ((fll[:, :, 257:286] * len_extra).sum(dim=2)
             + (fd * dist_extra).sum(dim=2))
    active = ((fll > 0).to(f32).sum(dim=2) + (fd > 0).to(f32).sum(dim=2))
    cost = (h_ll + h_d + extra + _TREE_FIXED + _TREE_PER_SYM * active
            + torch.log2(nll))
    stored = 42.0 + 8.0 * tile_bytes.to(f32)
    cost[:, 0] = torch.minimum(cost[:, 0], stored)
    return cost


def block_plan(ll_freq_micro: torch.Tensor, d_freq_micro: torch.Tensor,
               n_micro_valid, tile_bytes: torch.Tensor, max_merge: int = 8):
    """Choose dynamic-block boundaries over 32 KB tiles.

    ll_freq_micro (M, 286), d_freq_micro (M, 30): per-tile histograms.
    n_micro_valid: number of tiles covering real bytes (int or 0-d tensor).
    tile_bytes: (M,) real bytes per tile (prices the stored alternative).
    Returns (split bool[M], n_blocks): split[m] marks the first tile of
    each block; split[0] is always True.
    """
    M = ll_freq_micro.shape[0]
    dev = ll_freq_micro.device
    cost_all = segment_costs(ll_freq_micro, d_freq_micro, max_merge,
                             tile_bytes)
    ks = torch.arange(1, max_merge + 1, device=dev)

    # DP: opt[j] = min_k opt[j-k] + cost(j-k, j); opt_tail holds
    # opt[j-1], ..., opt[j-max_merge]. argmin takes the first minimum, as
    # jnp.argmin does.
    opt_tail = torch.full((max_merge,), _BIG, dtype=torch.float32, device=dev)
    opt_tail[0] = 0.0
    back = []
    for j in range(1, M + 1):
        cand = torch.where(j - ks >= 0, opt_tail + cost_all[j - 1],
                           torch.tensor(_BIG, dtype=torch.float32, device=dev))
        best_k = torch.argmin(cand)
        opt_tail = torch.cat([cand[best_k].unsqueeze(0), opt_tail[:-1]])
        back.append(best_k + 1)
    back_k = torch.stack(back)                       # back_k[j-1]: width

    # backtrack from n_micro_valid, marking block starts
    m_idx = torch.arange(M, device=dev)
    split = m_idx == 0
    jcur = torch.as_tensor(n_micro_valid, device=dev).long()
    for _ in range(M):
        k = back_k[(jcur - 1).clamp(min=0)]
        start = (jcur - k).clamp(min=0)
        live = jcur > 0
        split = split | ((m_idx == start) & live)
        jcur = torch.where(live, start, 0)
    n_blocks = (split & (m_idx < n_micro_valid)).sum()
    return split, n_blocks
