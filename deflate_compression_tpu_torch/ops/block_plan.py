"""The shard encoder's block-split DP: CUDA kernel wrapper and its plain
version.

Counterpart of deflate_compression_tpu/core/cost.py::block_plan (:34-160),
which the JAX package left to XLA: it has no Pallas kernel. From the tile
histograms, the estimated bits of every block of at most `max_merge` tiles
(`core/cost.py::segment_costs`), the DP over tile boundaries and the
backtrack from the last valid tile.

The kernel (`csrc/block_plan.cu`: a CTA of eight warps per end tile for
the segment costs; the CTA that finishes last runs the DP, its chain in one
thread's registers, and the backtrack; one launch) is built at first use by
`ops/cuda_build.py` and called through ctypes on PyTorch's current
stream. `block_plan` launches it for CUDA tensors and raises if it cannot;
it takes the plain version `block_plan_ref` only for tensors that lie on
the CPU. `block_plan.launches` counts the calls that launched it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.cost import segment_costs
from ..format import constants as C
from . import cuda_build

SOURCE = cuda_build.CSRC / "block_plan.cu"
MAX_TILES = 32767                # encode_shard's S < 2^30
MAX_MERGE = 32                   # the DP chain holds at most 32 candidates
_BIG = 3.4e38


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.load(SOURCE, {"block_plan_launch": [
        vp, vp, vp, i32, i32, i32, vp, vp, vp, vp, i32, vp]})
    return lib.block_plan_launch, cuda_build.raw_stream()


def _check(ll, dd, tile_bytes, n_valid: int, max_merge: int) -> None:
    args = {"ll_freq_micro": ll, "d_freq_micro": dd, "tile_bytes": tile_bytes}
    for name, x in args.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {x.dtype}")
        if x.device != ll.device:
            raise ValueError(f"{name} is on {x.device}, ll_freq_micro on "
                             f"{ll.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    M = ll.shape[0] if ll.dim() == 2 else -1
    if (ll.shape != (M, C.NUM_LITLEN) or dd.shape != (M, C.NUM_DIST)
            or tile_bytes.shape != (M,)):
        raise ValueError(f"want ll_freq_micro (M, 286), d_freq_micro (M, 30) "
                         f"and tile_bytes (M,), got {tuple(ll.shape)}, "
                         f"{tuple(dd.shape)}, {tuple(tile_bytes.shape)}")
    if not 1 <= M <= MAX_TILES:
        raise ValueError(f"M = {M} tiles outside [1, {MAX_TILES}]")
    if not 1 <= max_merge <= MAX_MERGE:
        raise ValueError(f"max_merge must be in [1, {MAX_MERGE}]")
    if not 0 <= n_valid <= M:
        raise ValueError(f"n_micro_valid = {n_valid} outside [0, {M}]")


def block_plan_ref(ll_freq_micro: torch.Tensor, d_freq_micro: torch.Tensor,
                   n_micro_valid: int, tile_bytes: torch.Tensor,
                   max_merge: int = 8, stats: dict | None = None):
    """Plain PyTorch version of the kernel. Arguments and result as for
    `block_plan`."""
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
    back, gaps = [], []
    for j in range(1, M + 1):
        valid = j - ks >= 0
        cand = torch.where(valid, opt_tail + cost_all[j - 1], _BIG)
        best_k = torch.argmin(cand)
        opt_tail = torch.cat([cand[best_k].unsqueeze(0), opt_tail[:-1]])
        back.append(best_k + 1)
        if stats is not None and 2 <= j <= n_micro_valid and max_merge > 1:
            rest = torch.where(valid & (ks != best_k + 1), cand, float("inf"))
            gaps.append(rest.min() - cand[best_k])
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
    if stats is not None:
        stats["cost"] = cost_all
        stats["gap"] = (torch.stack(gaps).min() if gaps else
                        torch.tensor(float("inf"), device=dev))
    return split, n_blocks


def block_plan(ll_freq_micro: torch.Tensor, d_freq_micro: torch.Tensor,
               n_micro_valid, tile_bytes: torch.Tensor, max_merge: int = 8,
               stats: dict | None = None):
    """Choose dynamic-block boundaries over 32 KB tiles.

    ll_freq_micro (M, 286), d_freq_micro (M, 30): per-tile histograms;
    tile_bytes (M,): real bytes per tile (prices the stored alternative);
    all int64, contiguous, on one device. n_micro_valid: the
    number of tiles covering real bytes (an int in [0, M]). Returns (split
    bool[M], n_blocks int64): split[m] marks the first tile of each block;
    split[0] is always True. With a `stats` dict, also the float32
    segment costs (M, max_merge) under "cost" and, under "gap", the
    smallest margin by which a DP step's best candidate beat its runner-up
    over steps 2..n_micro_valid (inf if none); from the kernel, also the
    clock64 cycles of its DP loop under "dp_cycles" (an int32 tensor; the
    plain version has none). A CUDA tensor goes through
    the CUDA kernel (or this raises); a CPU tensor through
    `block_plan_ref`."""
    n_valid = int(n_micro_valid)
    _check(ll_freq_micro, d_freq_micro, tile_bytes, n_valid, max_merge)
    dev = ll_freq_micro.device
    if dev.type == "cpu":
        return block_plan_ref(ll_freq_micro, d_freq_micro, n_valid,
                              tile_bytes, max_merge, stats)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M = ll_freq_micro.shape[0]
    # the segment costs, the smallest margin, the DP loop's cycles,
    # opt[0..M]
    scratch = torch.empty(M * max_merge + M + 3, dtype=torch.float32,
                          device=dev)
    split = torch.empty(M, dtype=torch.bool, device=dev)
    n_blocks = torch.empty((), dtype=torch.int64, device=dev)
    launch, stream = _bind()
    st = stream(dev.index)
    rc = launch(ll_freq_micro.data_ptr(), d_freq_micro.data_ptr(),
                tile_bytes.data_ptr(), M, max_merge, n_valid,
                scratch.data_ptr(), split.data_ptr(), n_blocks.data_ptr(),
                cuda_build.ticket(dev, st).data_ptr(), dev.index, st)
    if rc != 0:
        raise RuntimeError(f"block_plan launch failed: cudaError {rc}")
    block_plan.launches += 1
    if stats is not None:
        at = M * max_merge
        stats["cost"] = scratch[:at].view(M, max_merge)
        stats["gap"] = scratch[at]
        stats["dp_cycles"] = scratch[at + 1:at + 2].view(torch.int32)[0]
    return split, n_blocks


block_plan.launches = 0
