"""Multi-process launcher: torch.distributed set-up for the data-parallel
encode (counterpart of deflate_compression_tpu/parallel/launcher.py).

  * One process per device, as torchrun starts them: each reads RANK,
    WORLD_SIZE, LOCAL_RANK and MASTER_ADDR / MASTER_PORT from its
    environment, or takes them as arguments.
  * NCCL where the ranks encode on their cards, gloo where they run on the
    CPU (or where the caller asks for gloo); the process group gets a
    finite timeout, so a rank that hangs fails the others instead of
    holding them for torch's default of 10 minutes.
  * Per-process input slicing: process p reads shards p, p + P, p + 2P, ...

Outside a launched run it is a no-op: one process, no process group.
`dryrun_multichip(n)` starts n ranks on tiny shards and checks the
assembled stream with zlib.
"""
from __future__ import annotations

import datetime
import logging
import os
import socket
import zlib

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.errors import DistError
from ..utils.logging_util import LOGGER_NAME
from .dist import compress_distributed, encode_device, make_mesh

log = logging.getLogger(f"{LOGGER_NAME}.launcher")
DEFAULT_TIMEOUT_S = 300


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, device=None,
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Initialize the process group (a no-op for a single process).

    Resolution order: explicit arguments > torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR / MASTER_PORT) > one process. A group is set up
    when `init_method` is given or the world has more than one rank; the
    backend is NCCL when this rank encodes on a card (cuda:LOCAL_RANK
    unless `device` names another), gloo for device="cpu", or `backend`.
    A rank that finds no card raises; nothing moves to the CPU.

    Returns the JAX launcher's keys (process_index, process_count,
    local_devices, global_devices: one device per process), `group` (the
    default process group, None for one process) in the place of its
    mesh, and `device`, this rank's encode device."""
    dev = encode_device(device)
    ws = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    rk = rank if rank is not None else _env_int("RANK", 0)
    if (init_method is not None or ws > 1) and not tdist.is_initialized():
        if init_method is None:
            addr = os.environ.get("MASTER_ADDR")
            port = os.environ.get("MASTER_PORT")
            if not (addr and port):
                raise DistError("E_MESH", "WORLD_SIZE > 1 without "
                                "MASTER_ADDR / MASTER_PORT or init_method")
            init_method = f"tcp://{addr}:{port}"
        be = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if be == "nccl":
            torch.cuda.set_device(dev)
        tdist.init_process_group(
            be, init_method=init_method, world_size=ws, rank=rk,
            timeout=datetime.timedelta(seconds=timeout_s))
        log.info("process group up: rank %d/%d, %s, encode on %s", rk, ws,
                 be, dev)
    up = tdist.is_available() and tdist.is_initialized()
    count = tdist.get_world_size() if up else 1
    return {
        "group": tdist.group.WORLD if up else None,
        "device": dev,
        "process_index": tdist.get_rank() if up else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def host_shard_indices(n_shards: int, process_index: int | None = None,
                       process_count: int | None = None) -> range:
    """Round-robin shard ownership for per-process input reading."""
    up = tdist.is_available() and tdist.is_initialized()
    p = process_index if process_index is not None else (
        tdist.get_rank() if up else 0)
    n = process_count if process_count is not None else (
        tdist.get_world_size() if up else 1)
    return range(p, n_shards, n)


# ------------------------------------------------------------------ dry run

DRYRUN_SHARD = 32768                    # one coding block per shard


def _dryrun_input(n: int) -> bytes:
    """n shards of DRYRUN_SHARD bytes: text, 1000 random bytes, zeros (the
    JAX package's multichip dry run's rows)."""
    rng = np.random.default_rng(1)
    batch = np.zeros((n, DRYRUN_SHARD), np.uint8)
    for k in range(n):
        t = (b"shard %d data " % k) * 500
        batch[k, :len(t)] = np.frombuffer(t, np.uint8)
        batch[k, len(t):len(t) + 1000] = rng.integers(0, 256, 1000,
                                                      dtype=np.uint8)
    return batch.tobytes()


def _dryrun_rank(rank: int, n: int, init_method: str, device: str) -> None:
    """One rank of dryrun_multichip (a torch.multiprocessing target)."""
    dev = "cpu" if device == "cpu" else f"cuda:{rank}"
    init_distributed(init_method, n, rank, device=dev)
    try:
        raw = _dryrun_input(n)
        body = compress_distributed(raw, make_mesh(device=dev),
                                    shard_size=DRYRUN_SHARD,
                                    container="raw")
        if zlib.decompress(body, wbits=-15) != raw:
            raise AssertionError("multichip dryrun round-trip mismatch")
        if rank == 0:
            print(f"dryrun_multichip({n}): OK — {len(raw)} bytes -> "
                  f"{len(body)} bytes on {n} ranks ({device}), round-trip "
                  f"verified", flush=True)
    finally:
        tdist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Start n ranks (one process each, on cards 0..n-1 with NCCL, or on
    the CPU with gloo for device="cpu"), encode n tiny shards through
    compress_distributed and check the stream with zlib. Raises if a rank
    fails or there are fewer than n cards."""
    device = "cpu" if str(device) == "cpu" else "cuda"
    if device == "cuda":
        encode_device("cuda")
        if torch.cuda.device_count() < n_devices:
            raise DistError("E_MESH", f"need {n_devices} CUDA devices, "
                            f"have {torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(
        _dryrun_rank, args=(n_devices, f"tcp://127.0.0.1:{port}", device),
        nprocs=n_devices, join=True)
