"""The decode cells' streams: each object encoded once by the port's
encoder, then read back from a cache in the checkout.

On a cell's first run in a checkout the objects are made from each of
the traffic's content seeds and encoded by `compress_stream` with an index
sink; `index_from_shards` turns the sink into the decode index a reader
of the stream holds. Each object's raw DEFLATE body, its zlib footer's
Adler-32, the index and the Adler-32 of each shard of the object
(zlib's, the checksum index the device decode compares with) are
written to `cache/<config>-<content seed>-<scale>-<hash>/`. A run reads
back the streams of the content seed that its `--seed` draws; all of them
are built at once, so that only a checkout's first run encodes. The hash
covers every file of the port and the files that make the objects, so a
changed encoder or generator never reads a stale stream.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

from . import inputs, reference
from .entries import codec_config

HERE = Path(__file__).resolve().parent
PORT = HERE.parent / "deflate_compression_tpu_torch"
_INDEX_KEYS = ("bit_base", "out_start", "btype", "sub_bit", "sub_out",
               "sub_blk")


def source_hash(cfg: dict) -> str:
    h = hashlib.sha256(repr(sorted(cfg.items())).encode())
    files = [p for p in sorted(PORT.rglob("*"))
             if p.is_file() and "build" not in p.relative_to(PORT).parts
             and "__pycache__" not in p.parts]
    files += [HERE / "inputs.py"] + sorted((HERE / "data").iterdir())
    for p in files:
        h.update(str(p.relative_to(HERE.parent)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def cache_dir(cfg: dict, content_seed: int, scale: int,
              root: Path | None = None) -> Path:
    root = HERE / "cache" if root is None else Path(root)
    return root / (f"{cfg['name']}-{content_seed}-{scale}-"
                   f"{source_hash(cfg)}")


def build(objs: list[bytes], cfg: dict, dev, where: Path) -> None:
    """Encode every object with the port and write the cache."""
    from deflate_compression_tpu_torch.decode.index import index_from_shards
    from deflate_compression_tpu_torch.models.codec import compress_stream
    ccfg = codec_config(cfg)
    where.mkdir(parents=True, exist_ok=True)
    for i, obj in enumerate(objs):
        sink = []
        blob = b"".join(compress_stream([obj], ccfg, index_sink=sink,
                                        device=dev))
        idx = index_from_shards([t[0] for t in sink], [t[1] for t in sink],
                                [t[2] for t in sink])
        arrays = {k: np.zeros(0, np.int64) if getattr(idx, k) is None
                  else getattr(idx, k) for k in _INDEX_KEYS}
        tmp = where / f"obj{i}.{os.getpid()}.tmp.npz"
        np.savez(tmp, body=np.frombuffer(blob[2:-4], np.uint8),
                 adler=np.int64(int.from_bytes(blob[-4:], "big")),
                 out_len=np.int64(idx.out_len),
                 shard_adler=np.array(reference.shard_adlers(
                     obj, cfg["shard_size"]), np.int64), **arrays)
        os.replace(tmp, where / f"obj{i}.npz")


def load(where: Path, n: int) -> list[dict]:
    """Each object's body (bytes), adler, the decode index and the
    shards' Adler-32."""
    from deflate_compression_tpu_torch.decode.index import DecodeIndex
    out = []
    for i in range(n):
        with np.load(where / f"obj{i}.npz") as z:
            idx = DecodeIndex(z["bit_base"], z["out_start"], z["btype"],
                              int(z["out_len"]), z["sub_bit"], z["sub_out"],
                              z["sub_blk"])
            out.append({"body": z["body"].tobytes(),
                        "adler": int(z["adler"]), "index": idx,
                        "shard_adler": z["shard_adler"].tolist()})
    return out


def ready(where: Path, n: int) -> bool:
    return all((where / f"obj{i}.npz").exists() for i in range(n))


def streams(cfg: dict, traffic: dict, content_seed: int, dev,
            scale: int = 1, root: Path | None = None) -> list[dict]:
    """The streams of `content_seed`, one of the traffic's content seeds;
    those of every content seed are built on the first run in a
    checkout."""
    listed = traffic["objects"]
    n = len(inputs.objects(listed))
    for cs in traffic["content_seeds"]:
        where = cache_dir(cfg, cs, scale, root)
        if not ready(where, n):
            build(inputs.make(cs, scale, listed), cfg, dev, where)
    return load(cache_dir(cfg, content_seed, scale, root), n)
