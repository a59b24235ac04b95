"""Data-parallel encode over torch.distributed (counterpart of
deflate_compression_tpu/parallel/dist.py).

DEFLATE shards concatenate: each starts a fresh 32 KB window and a
non-final shard ends byte-aligned with an empty stored block
(format/deflate.py), so ranks encode shards on their own and meet only to
assemble the container. The program is SPMD: every rank calls
`compress_distributed` with the same bytes, and every rank returns the same
container. Without a process group it runs as one rank with no
collectives.

  * Mesh: one rank per device, the process group in the place of the JAX
    package's 1-D "shards" mesh. Collectives run on the group's device (the
    card for NCCL, the CPU for gloo); each rank encodes on its own device.
  * Waves: rank r encodes shard wave * W + r with `encode_shard`. A rank
    with no shard in the last wave encodes nothing, but joins every
    collective with a byte count of 0 (the JAX package encodes a padded row
    there and drops it; the bytes are the same).
  * Ordered assembly on the host: all_gather the byte counts, take each
    shard's offset as an exclusive sum, all_gather every rank's bytes padded
    to the wave's largest count, and place them in shard order. This stands
    for the JAX package's on-device ragged gather.
  * Checksums: each shard's adler32 by `adler32_torch` on its encode
    device, gathered and combined on the host in shard order; gzip's CRC-32
    on the host over the input.
  * Faults: before any exchange the ranks agree on every rank's status with
    one all_reduce, so a rank that raises never leaves the others waiting
    in a collective. A failed wave is encoded again on every rank (the
    output is fixed by input, configuration and shard plan), up to
    `max_retries` times; then every rank raises DistError("E_SHARD").
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
import torch.distributed as tdist

from ..core import checksum
from ..decode.index import INDEX_STAT_FIELDS, DecodeIndex, index_from_shards
from ..device import pick_device
from ..format import containers
from ..format.deflate import BLOCK, encode_shard, shard_bytes
from ..utils.errors import DeflateError, DistError
from ..utils.logging_util import LOGGER_NAME

_LOG = logging.getLogger(f"{LOGGER_NAME}.parallel.dist")
EMPTY_STREAM = b"\x01\x00\x00\xff\xff"      # one empty final stored block


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data-parallel encode."""
    rank: int
    world: int
    group: object | None            # None: one rank, no collectives
    comm_device: torch.device       # where collectives' tensors live
    device: torch.device            # where this rank encodes


def encode_device(device=None) -> torch.device:
    """A rank's encode device: cuda:LOCAL_RANK for None or "cuda", else the
    device asked for. Raises where there is no card (or no card of that
    index) unless "cpu" is asked for."""
    if device is None or str(device) == "cuda":
        pick_device("cuda")
        lr = int(os.environ.get("LOCAL_RANK", "0"))   # torchrun sets it
        if lr >= torch.cuda.device_count():
            raise DistError("E_MESH", f"LOCAL_RANK {lr} but only "
                            f"{torch.cuda.device_count()} CUDA devices")
        return torch.device("cuda", lr)
    return pick_device(device)


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of `group` (the default group when one is initialized, else
    a single rank) with this rank encoding on `device` (see
    `encode_device`)."""
    dev = encode_device(device)
    if not (tdist.is_available() and tdist.is_initialized()):
        if group is not None:
            raise DistError("E_MESH", "a group was given but torch."
                            "distributed is not initialized")
        return Mesh(0, 1, None, dev, dev)
    g = group if group is not None else tdist.group.WORLD
    if tdist.get_backend(g) == "nccl":
        comm = dev if dev.type == "cuda" else torch.device(
            "cuda", torch.cuda.current_device())
    else:
        comm = torch.device("cpu")
    return Mesh(tdist.get_rank(g), tdist.get_world_size(g), g, comm, dev)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Stack every rank's `t` (same shape and dtype on each) in rank order,
    on the host."""
    if mesh.group is None:
        return t.unsqueeze(0).cpu()
    t = t.to(mesh.comm_device)
    outs = [torch.empty_like(t) for _ in range(mesh.world)]
    tdist.all_gather(outs, t, group=mesh.group)
    return torch.stack(outs).cpu()


def _agree_failed(mesh: Mesh, failed: bool) -> list:
    """Every rank's failure flag, the same list on every rank (one
    all_reduce)."""
    st = torch.zeros(mesh.world, dtype=torch.int64)
    st[mesh.rank] = int(failed)
    if mesh.group is not None:
        st = st.to(mesh.comm_device)
        tdist.all_reduce(st, group=mesh.group)
    return [r for r, v in enumerate(st.cpu().tolist()) if v]


_SCALAR_STATS = ("n_blocks", "sub_overflow")


def _stat_sizes(S: int) -> list:
    """Element count of each INDEX_STAT_FIELDS entry of an S-byte shard's
    encoder result: NB per block field, S / 64 per sub-entry field."""
    return [1 if k in _SCALAR_STATS else
            S // 64 if k.startswith("sub_") else S // BLOCK
            for k in INDEX_STAT_FIELDS]


def _stat_vector(r: dict | None, S: int) -> torch.Tensor:
    """INDEX_STAT_FIELDS of one shard's result as one int64 vector of a
    size fixed by S (zeros for a rank with no shard)."""
    if r is None:
        return torch.zeros(sum(_stat_sizes(S)), dtype=torch.int64)
    return torch.cat([r[k].reshape(-1).to(torch.int64).cpu()
                      for k in INDEX_STAT_FIELDS])


def _split_stats(v: np.ndarray, S: int) -> dict:
    """The inverse of `_stat_vector`: field -> numpy array (0-d for the
    scalar fields)."""
    ends = np.cumsum(_stat_sizes(S))
    return {k: v[e - 1] if k in _SCALAR_STATS else v[e - n:e]
            for k, e, n in zip(INDEX_STAT_FIELDS, ends, _stat_sizes(S))}


def _encode_one(raw: bytes, s: int, nsh: int, S: int, dev, options: dict):
    """Shard s of raw on dev: (its substream bytes, adler32, valid bytes,
    encode_shard's result)."""
    part = raw[s * S:(s + 1) * S]
    buf = np.zeros(S, dtype=np.uint8)
    buf[:len(part)] = np.frombuffer(part, dtype=np.uint8)
    x = torch.from_numpy(buf).to(dev)
    r = encode_shard(x, len(part), s == nsh - 1, **options)
    return shard_bytes(r), int(checksum.adler32_torch(x, len(part))), \
        len(part), r


def compress_distributed(raw: bytes, mesh: Mesh | None = None,
                         shard_size: int = 1 << 20,
                         num_candidates: int = 32, lazy: bool = True,
                         container: str = "zlib", max_retries: int = 2,
                         force_btype: int | None = None,
                         return_index: bool = False, device=None,
                         _fault_hook=None):
    """Shard `raw` over the mesh's ranks, encode in waves of W shards,
    assemble the substreams in shard order and wrap them in the container
    (zlib: adler32 per shard on the device, combined on the host; gzip:
    host CRC-32 and ISIZE; raw: bare DEFLATE). Unknown containers raise.

    Every rank passes the same `raw` and options and gets the same bytes,
    equal to the single-device codec's for the same shard plan. `mesh`
    defaults to `make_mesh(device=device)`: the initialized default group,
    or one rank.

    With return_index=True the per-shard encoder stats are gathered too and
    the result is (bytes, decode.index.DecodeIndex), with no host pass over
    the stream.

    Faults: `_fault_hook(wave, attempt)` (a test seam) runs on every rank
    before each attempt and may raise. A wave where any rank raised is
    encoded again on every rank, up to `max_retries` times; then every rank
    raises DistError("E_SHARD"). A sub-entry overflow raises
    DeflateError("E_INDEX") on every rank."""
    if container not in ("zlib", "gzip", "raw"):
        raise ValueError(f"unknown container {container!r}")
    mesh = mesh or make_mesh(device=device)
    W = mesh.world
    S = max(BLOCK, (shard_size // BLOCK) * BLOCK)
    n = len(raw)
    if n == 0:
        out = _wrap(EMPTY_STREAM, container, raw)
        if return_index:
            return out, DecodeIndex(np.zeros(1, np.int64),
                                    np.zeros(1, np.int64),
                                    np.zeros(1, np.uint8), 0)
        return out

    options = dict(num_candidates=num_candidates, lazy=lazy,
                   force_btype=force_btype)
    nsh = (n + S - 1) // S
    parts = []
    adler = 1
    idx_shards = []                     # (stats, nbits, out_len) per shard
    for wave in range(0, nsh, W):
        s = wave + mesh.rank
        mine = None
        for attempt in range(max_retries + 1):
            err = None
            try:
                if _fault_hook is not None:
                    _fault_hook(wave // W, attempt)
                mine = (_encode_one(raw, s, nsh, S, mesh.device, options)
                        if s < nsh else None)
            except Exception as e:  # deterministic re-encode on any fault
                _LOG.warning("rank %d wave %d attempt %d failed: %s",
                             mesh.rank, wave // W, attempt, e,
                             exc_info=True)
                err = e
            failed = _agree_failed(mesh, err is not None)
            if not failed:
                break
        if failed:
            raise DistError(
                "E_SHARD",
                f"wave {wave // W} failed after {max_retries + 1} attempts "
                f"on ranks {failed}" + (f": {err}" if err else ""))

        body, ad, vl, r = mine if mine is not None else (b"", 1, 0, None)
        meta = _all_gather(mesh, torch.tensor(
            [len(body), ad, vl, int(bool(r["sub_overflow"])) if r else 0],
            dtype=torch.int64)).numpy()
        if meta[:, 3].any():
            raise DeflateError("E_INDEX",
                               f"wave {wave // W}: sub-entry capacity "
                               "overflow — index would be incomplete")
        sizes = meta[:, 0]
        offsets = np.cumsum(sizes) - sizes       # exclusive sum
        buf = torch.zeros(int(sizes.max()), dtype=torch.uint8)
        if body:
            buf[:len(body)] = torch.frombuffer(bytearray(body),
                                               dtype=torch.uint8)
        flat = _all_gather(mesh, buf).numpy()
        wave_bytes = np.zeros(int(sizes.sum()), np.uint8)
        for k in range(W):
            wave_bytes[offsets[k]:offsets[k] + sizes[k]] = flat[k, :sizes[k]]
        if return_index:
            stats = _all_gather(mesh, _stat_vector(r, S)).numpy()
        _LOG.debug("wave %d: %d shards -> %d bytes", wave // W,
                   min(W, nsh - wave), int(sizes.sum()))
        for k in range(min(W, nsh - wave)):
            adler = checksum.adler32_combine(adler, int(meta[k, 1]),
                                             int(meta[k, 2]))
            if return_index:
                idx_shards.append((_split_stats(stats[k], S),
                                   8 * int(sizes[k]), int(meta[k, 2])))
        parts.append(wave_bytes.tobytes())
    out = _wrap(b"".join(parts), container, raw, adler)
    if return_index:
        idx = index_from_shards([t[0] for t in idx_shards],
                                [t[1] for t in idx_shards],
                                [t[2] for t in idx_shards])
        return out, idx
    return out


def _wrap(body: bytes, container: str, raw: bytes, adler: int = 1) -> bytes:
    """Container framing: zlib takes the combined adler32; gzip the host
    CRC-32 over `raw` (core/checksum.crc32_np) and ISIZE (RFC 1952)."""
    if container == "zlib":
        return containers.zlib_wrap(body, adler)
    if container == "gzip":
        return containers.gzip_wrap(body, checksum.crc32_np(raw), len(raw))
    return body
