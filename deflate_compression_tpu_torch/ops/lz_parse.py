"""The LZ77 stage after the match finder: CUDA kernel wrapper and its plain
version.

Counterpart of deflate_compression_tpu/core/lz77.py::tokenize after
find_matches (:497-577) and its greedy_parse (:340-464), which the JAX
package left to XLA: they have no Pallas kernel. From find_matches'
(length, dist): constant runs become exact distance-1 matches, matches
chain to 258 bytes, tokens are clamped to the valid region and to 32 KB
tile boundaries, two-step lazy matching demotes a match that a longer one
follows, and the greedy parse marks the token starts: the orbit of 0 under
next[i] = i + max(length[i], 1).

The kernels (`csrc/lz_parse.cu`: one CTA per 4 KB sub-tile for runs,
chains, clamps and lazy, then one per 32 KB tile for the parse) are built
at first use by `ops/cuda_build.py` and called through ctypes on PyTorch's
current stream; the call waits for nothing on the device. The kernels read
find_matches' result packed as one int32 a position: `lz_parse_packed`
takes it so (`find_matches_packed`, what tokenize hands over), `lz_parse`
packs the int64 pair first.

Both launch the kernels for CUDA tensors and raise if they cannot; they
take the plain version `lz_parse_ref` only for tensors that lie on the
CPU. `lz_parse.launches` counts the calls of either that launched.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import scans
from ..format import constants as C
from . import cuda_build
from .find_matches import pack, unpack

SOURCE = cuda_build.CSRC / "lz_parse.cu"
TILE = C.WINDOW_SIZE                            # one parse CTA per tile
PADDED_TILE = TILE + 2 * (TILE // 64)           # token lengths, chunk-padded


@functools.cache
def _bind():
    """The kernels' launch function, bound once, and the raw current-stream
    lookup."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {"lz_parse_launch": [
        vp, vp, i64, i64, i32, vp, vp, vp, vp, i32, vp]})
    return lib.lz_parse_launch, cuda_build.raw_stream()


def _shift_down(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """y[i] = x[i-k], the first k filled."""
    k = min(k, x.shape[0])
    return torch.cat([torch.full((k,), fill, dtype=x.dtype, device=x.device),
                      x[:-k]])


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[i] = x[i+k], the last k zero."""
    k = min(k, x.shape[0])
    return torch.cat([x[k:], torch.zeros(k, dtype=x.dtype, device=x.device)])


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


def lz_parse_ref(data: torch.Tensor, length: torch.Tensor,
                 dist: torch.Tensor, valid_len: int, lazy: bool = True):
    """Plain PyTorch version of the kernel. Arguments and result as for
    `lz_parse`."""
    S = data.shape[0]
    dev = data.device
    pos = torch.arange(S, device=dev)

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


def _check(data, **matches) -> None:
    """data u8[S], and each of `matches` (name: (tensor, dtype)) of that
    dtype and shape, on data's device; all contiguous."""
    if not isinstance(data, torch.Tensor) or not all(
            isinstance(x, torch.Tensor) for x, _ in matches.values()):
        raise TypeError(f"data, {', '.join(matches)} must be torch.Tensors")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data must be u8[S], got {data.dtype} "
                         f"{tuple(data.shape)}")
    for name, (x, dtype) in matches.items():
        if x.dtype != dtype or x.shape != data.shape:
            raise ValueError(f"{name} must be {dtype}[{data.shape[0]}]")
        if x.device != data.device:
            raise ValueError(f"{name} is on {x.device}, data on "
                             f"{data.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.shape[0] > 2**31 - 1:
        raise ValueError("data longer than 2^31 - 1 bytes")


def _launch(data: torch.Tensor, packed: torch.Tensor, valid_len: int,
            lazy: bool) -> dict:
    """Both kernels on CUDA tensors."""
    dev = data.device
    S = data.shape[0]
    out = {"chosen": torch.empty(S, dtype=torch.bool, device=dev),
           "length": torch.empty(S, dtype=torch.int64, device=dev),
           "dist": torch.empty(S, dtype=torch.int64, device=dev)}
    if S == 0:
        return out
    launch, stream = _bind()
    tok_len = torch.empty(-(-S // TILE) * PADDED_TILE, dtype=torch.int16,
                          device=dev)
    rc = launch(data.data_ptr(), packed.data_ptr(), S, valid_len,
                int(bool(lazy)), out["chosen"].data_ptr(),
                out["length"].data_ptr(), out["dist"].data_ptr(),
                tok_len.data_ptr(), dev.index, stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"lz_parse launch failed: cudaError {rc}")
    lz_parse.launches += 1
    return out


def lz_parse(data: torch.Tensor, length: torch.Tensor, dist: torch.Tensor,
             valid_len: int, lazy: bool = True):
    """Runs, chain extension, clamps, lazy matching and the greedy parse of
    one shard, from find_matches' result.

    data: contiguous u8[S] (the tail past valid_len is padding); length,
    dist: int64[S] as find_matches returns them (lengths in [0, 258],
    distances in [0, 32768]). Returns a dict of per-position tensors:
    chosen (bool, a token starts here), length and dist (int64, 0 for a
    literal; dist stays where a clamp cut a match below 3 bytes). Padding
    positions are never chosen. A CUDA tensor goes through the CUDA kernels
    (or this raises); a CPU tensor through `lz_parse_ref`."""
    _check(data, length=(length, torch.int64), dist=(dist, torch.int64))
    valid_len = int(valid_len)
    dev = data.device
    if dev.type == "cpu":
        return lz_parse_ref(data, length, dist, valid_len, lazy)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(data, pack(length, dist), valid_len, lazy)


def lz_parse_packed(data: torch.Tensor, packed: torch.Tensor,
                    valid_len: int, lazy: bool = True):
    """`lz_parse` from find_matches' packed result (int32[S], length |
    dist << 16, as `find_matches_packed` gives it): the same dict."""
    _check(data, packed=(packed, torch.int32))
    valid_len = int(valid_len)
    dev = data.device
    if dev.type == "cpu":
        return lz_parse_ref(data, *unpack(packed), valid_len, lazy)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(data, packed, valid_len, lazy)


lz_parse.launches = 0
