"""LZ77 match finder: CUDA kernel wrapper and its plain version.

Counterpart of deflate_compression_tpu/core/lz77.py::find_matches, which
the JAX package left to XLA: it has no Pallas kernel. Per position of a
shard (bytes read as 0 past its end): a 16-bit multiplicative hash of the
next three bytes; the K nearest earlier positions with the same hash, a
hash collision using up one of the K, none more than 32768 back; each
scored on its leading equal bytes up to 11, the most winning and the
nearest breaking ties; the winner rescored to 35 bytes; then length =
min(that, 258, S - i), 0 under 3, and dist = i - j where length > 0.

Both versions walk the hash chain: `back[i]` is the distance to the
nearest earlier position with i's hash (0 for none, or where it lies over
32768 back), from one stable sort by hash, and the candidates of i are
i - back[i], then that one's link, ... The kernels (`csrc/find_matches.cu`:
the hash, CUB's stable radix sort of the 16-bit keys with int32
positions, the links and the walk, one C call) are built at first use by
`ops/cuda_build.py` and called through ctypes on PyTorch's current
stream; the call waits for nothing on the device. The kernels write one
int32 a position, length | dist << 16: `find_matches_packed` returns it
as it is (what tokenize hands to lz_parse), `find_matches` unpacked into
two int64 arrays.

Both launch the kernels for a CUDA tensor and raise if they cannot; they
take the plain version `find_matches_ref` only for a tensor that lies on
the CPU. `find_matches.launches` counts the calls of either that
launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.u32 import mul32
from ..format import constants as C
from . import cuda_build

SOURCE = cuda_build.CSRC / "find_matches.cu"
HASH_BITS = 16
HASH_MUL = 2654435761
MAX_CANDIDATES = 255
PRESELECT = 11                  # bytes scored per candidate (2 words + 3)
RESCORE = 35                    # bytes scored for the winner (8 words + 3)
# int32 positions in the kernels, with a CTA's staged bytes past the end
# (csrc/find_matches.cu: kStage)
MAX_BYTES = 2**31 - 1 - (C.WINDOW_SIZE + 4096 + RESCORE + 8)


@functools.cache
def _bind():
    """The launch function and the sort's scratch-size query, bound once,
    and the raw current-stream lookup."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {
        "find_matches_temp_bytes": [i64, ctypes.POINTER(ctypes.c_int64)],
        "find_matches_launch": [vp, i64, vp, vp, vp, vp, vp, i64, vp, i32,
                                vp, i32, vp]})
    return (lib.find_matches_launch, lib.find_matches_temp_bytes,
            cuda_build.raw_stream())


def _check(data: torch.Tensor, num_candidates: int) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError("data must be a torch.Tensor")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data must be u8[S], got {data.dtype} "
                         f"{tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if not 1 <= num_candidates <= MAX_CANDIDATES:
        raise ValueError(f"num_candidates must be in [1, {MAX_CANDIDATES}]")
    if data.shape[0] > MAX_BYTES:
        raise ValueError(f"data longer than {MAX_BYTES} bytes")


def _hash3(data: torch.Tensor) -> torch.Tensor:
    """h[i] of the three bytes at i (0 past the end), int64."""
    d = data.long()
    d1 = torch.cat([d[1:], d.new_zeros(1)])[:d.shape[0]]
    d2 = torch.cat([d[2:], d.new_zeros(2)])[:d.shape[0]]
    return mul32(d | (d1 << 8) | (d2 << 16), HASH_MUL) >> (32 - HASH_BITS)


def _back_links(h: torch.Tensor) -> torch.Tensor:
    """back[i]: i minus the nearest earlier position with hash h[i] if that
    lies within the window, else 0 (a link past the window is past every
    later position's window too): the kernels' 16-bit links, from one
    stable sort by hash."""
    order = torch.argsort(h, stable=True)
    hs = h[order]
    d = order[1:] - order[:-1]
    back = torch.zeros_like(order)
    back[order[1:]] = torch.where((hs[1:] == hs[:-1]) & (d <= C.WINDOW_SIZE),
                                  d, 0)
    return back


def _tail_bytes(diff: torch.Tensor) -> torch.Tensor:
    """Leading equal bytes (0-3) of an LSB-first u32 word diff."""
    return torch.where((diff & 0xFF) != 0, 0,
                       torch.where((diff & 0xFFFF) != 0, 1,
                                   torch.where((diff & 0xFFFFFF) != 0, 2, 3)))


def _leading_equal(w4: torch.Tensor, at: torch.Tensor, cand: torch.Tensor,
                   cap: int):
    """min(leading equal bytes of b[at..] and b[cand..], cap) per pair,
    cap = 4 * words + 3, from the 4-byte words w4 of the zero-padded
    bytes."""
    words = (cap - 3) // 4
    run = torch.ones_like(at)
    nw = torch.zeros_like(at)
    first_diff = torch.zeros_like(at)
    for t in range(words + 1):
        diff = w4[at + 4 * t] ^ w4[cand + 4 * t]
        if t == words:                           # the tail word
            first_diff = torch.where(run > 0, diff, first_diff)
            break
        first_diff = torch.where((run > 0) & (diff != 0), diff, first_diff)
        run = run * (diff == 0)
        nw = nw + run
    return 4 * nw + _tail_bytes(first_diff)


def find_matches_ref(data: torch.Tensor, num_candidates: int = 32,
                     stats: dict | None = None):
    """Plain PyTorch version of the kernels, the same chain walk: K rounds
    of `cand = cand - back[cand]` with the bytes compared in place.
    Arguments and result as for `find_matches`; `stats`, if given, receives
    the walk's work: `visits` (candidates scored, a chain left once a
    candidate reaches 11 bytes) and `rescore_words` (the 4-byte compares
    that take the 11-byte winners on toward 35 bytes)."""
    S = data.shape[0]
    dev = data.device
    pos = torch.arange(S, device=dev)
    d = torch.cat([data.long(), torch.zeros(RESCORE + 8, dtype=torch.int64,
                                            device=dev)])
    w4 = d[:-3] | (d[1:-2] << 8) | (d[2:-1] << 16) | (d[3:] << 24)
    back = _back_links(_hash3(data))
    prev = torch.where(back > 0, pos - back, -1)

    best = torch.full((S,), -1, dtype=torch.int64, device=dev)
    best_nb = torch.full_like(best, -1)
    visits = 0
    # the walk, round k on the positions whose chain is still open; none
    # beats a candidate of 11 bytes, so its chain closes there
    at, cand = pos, prev
    for _ in range(num_candidates):
        ok = ((cand >= 0) & (at - cand <= C.WINDOW_SIZE)
              & (best_nb[at] < PRESELECT))
        at, cand = at[ok], cand[ok]
        if at.numel() == 0:
            break
        nb = _leading_equal(w4, at, cand, PRESELECT)
        win = nb > best_nb[at]                   # strict: the nearest wins
        best[at[win]] = cand[win]
        best_nb[at[win]] = nb[win]
        cand = prev[cand]
        visits += at.numel()

    valid = best >= 0
    bc = best.clamp(min=0)
    length = _leading_equal(w4, pos, bc, RESCORE).clamp(max=C.MAX_MATCH)
    if stats is not None:
        # a word from byte 11 on, until one differs or 35 are equal
        run = length[best_nb == PRESELECT]
        stats["visits"] = visits
        stats["rescore_words"] = int(
            ((run - PRESELECT) // 4 + 1).clamp(max=6).sum())
    length = torch.minimum(length, S - pos)      # padding equality is fake
    length = torch.where(valid & (length >= C.MIN_MATCH), length, 0)
    dist = torch.where(length > 0, pos - bc, 0)
    return length, dist


def pack(length: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """The hand-off of find_matches to lz_parse: int32 length | dist << 16
    (dist 32768 sets the sign bit), both in [0, 65535]; written as the two
    16-bit halves of each word."""
    out = torch.empty((length.shape[0], 2), dtype=torch.int16,
                      device=length.device)
    out[:, 0] = length                           # low half, little-endian
    out[:, 1] = dist
    return out.view(torch.int32).view(-1)


def unpack(packed: torch.Tensor):
    """(length, dist) int64 of a packed hand-off."""
    half = packed.view(torch.int16).view(-1, 2)
    return (half[:, 0].long().bitwise_and_(0xFFFF),
            half[:, 1].long().bitwise_and_(0xFFFF))


def _launch(data: torch.Tensor, num_candidates: int) -> torch.Tensor:
    """The kernels on a CUDA tensor: the packed int32 result."""
    dev = data.device
    S = data.shape[0]
    out = torch.empty(S, dtype=torch.int32, device=dev)
    if S == 0:
        return out
    launch, temp_bytes, stream = _bind()
    n = ctypes.c_int64()
    rc = temp_bytes(S, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"find_matches sort size failed: cudaError {rc}")
    keys = torch.empty((2, S), dtype=torch.int16, device=dev)
    pos = torch.empty((2, S), dtype=torch.int32, device=dev)
    temp = torch.empty(max(n.value, 1), dtype=torch.uint8, device=dev)
    back = torch.empty(-(-S // 8) * 8, dtype=torch.int16, device=dev)
    rc = launch(data.data_ptr(), S, keys[0].data_ptr(), keys[1].data_ptr(),
                pos[0].data_ptr(), pos[1].data_ptr(), temp.data_ptr(),
                n.value, back.data_ptr(), num_candidates, out.data_ptr(),
                dev.index, stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"find_matches launch failed: cudaError {rc}")
    find_matches.launches += 1
    return out


def find_matches(data: torch.Tensor, num_candidates: int = 32):
    """Best match per position: (length, dist), int64[S]; length 0 where
    no usable match. Lengths are capped at 35.

    data: contiguous u8[S]. A CUDA tensor goes through the CUDA kernels (or
    this raises); a CPU tensor through `find_matches_ref`."""
    _check(data, num_candidates)
    dev = data.device
    if dev.type == "cpu":
        return find_matches_ref(data, num_candidates)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return unpack(_launch(data, num_candidates))


def find_matches_packed(data: torch.Tensor, num_candidates: int = 32):
    """find_matches' result as one int32[S], `pack(length, dist)`: what
    tokenize hands to lz_parse (4 bytes a position written, not 16). A
    CUDA tensor goes through the CUDA kernels (or this raises); a CPU
    tensor through `find_matches_ref`."""
    _check(data, num_candidates)
    dev = data.device
    if dev.type == "cpu":
        return pack(*find_matches_ref(data, num_candidates))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(data, num_candidates)


find_matches.launches = 0
