"""Adaptive block splitting from tile histograms (counterpart of
deflate_compression_tpu/core/cost.py).

The cost of coding tiles [i, j) as one dynamic block is estimated as
sum f*log2(n/f) + exact extra bits + a tree-description estimate, and a DP
over tile boundaries (merge runs of at most `max_merge` tiles) picks the
segmentation (ops/block_plan.py: the DP and the backtrack, its kernel on
the card). This is the encoder's one float stage: it stays in float32
with the JAX package's expression order, since a changed rounding can
flip a near-tie split. torch's log2 and sums still round otherwise than
XLA's, so a DP step whose two best candidates lie within a few ulps can
split otherwise than the JAX package (ROADMAP, queue 3).
"""
from __future__ import annotations

import functools

import torch

from ..format import constants as C

_TREE_FIXED = 17.0 + 3 * 15
_TREE_PER_SYM = 5.5


@functools.cache
def _extra_bits(dev: torch.device):
    """The length and distance codes' extra bits as float32 on `dev`, built
    once per device."""
    return (torch.as_tensor(C.LENGTH_EXTRA, dtype=torch.float32, device=dev),
            torch.as_tensor(C.DIST_EXTRA, dtype=torch.float32, device=dev))


def segment_costs(ll_freq_micro: torch.Tensor, d_freq_micro: torch.Tensor,
                  max_merge: int, tile_bytes: torch.Tensor) -> torch.Tensor:
    """f32[M, max_merge]: estimated bits of the block of tiles
    [max(j-k, 0), j) for j = 1..M and k = 1..max_merge; column 0 (single
    tiles) takes the stored price when that is lower."""
    M = ll_freq_micro.shape[0]
    dev = ll_freq_micro.device
    f32 = torch.float32
    len_extra, dist_extra = _extra_bits(dev)

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
    """Choose dynamic-block boundaries over 32 KB tiles: the block_plan op
    (ops/block_plan.py; the CUDA kernel on the card), which takes int64:
    other integer counts are converted (the encoder's already are).
    Returns (split bool[M], n_blocks); split[m] marks the first tile of
    each block."""
    # imported here: the op's plain version uses segment_costs above
    from ..ops.block_plan import block_plan as op
    ll, dd, tb = (x.long().contiguous()
                  for x in (ll_freq_micro, d_freq_micro, tile_bytes))
    return op(ll, dd, n_micro_valid, tb, max_merge)
