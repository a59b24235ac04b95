"""The gzip cells' members: each object written once as a gzip member by
CPython's gzip module, then read back from a cache in the checkout.

The port did not write these streams (a foreign writer: gzip -9, Python's
gzip and tarfile), so the cache is keyed by what makes them and not by the
port's source: the generator's files (`inputs.py`, `data/`), the
configuration's stream keys and the zlib library that ran
(`zlib.ZLIB_RUNTIME_VERSION`). On a cell's first run in a checkout the
members of every content seed of the traffic are written at once, on
several threads (zlib leaves the interpreter's lock while it compresses),
to `cache/<config>-<content seed>-<scale>-<hash>/obj<i>.gz`; a run reads
back those of the content seed its `--seed` draws.
"""
from __future__ import annotations

import concurrent.futures
import gzip
import hashlib
import io
import os
import zlib
from pathlib import Path

from . import inputs

HERE = Path(__file__).resolve().parent
STREAM_KEYS = ("compresslevel", "wbits", "mem_level", "header", "objects")


def writer_hash(cfg: dict) -> str:
    h = hashlib.sha256(repr([(k, cfg[k]) for k in STREAM_KEYS]).encode())
    h.update(zlib.ZLIB_RUNTIME_VERSION.encode())
    for p in [HERE / "inputs.py", HERE / "members.py"] + sorted(
            (HERE / "data").iterdir()):
        h.update(str(p.relative_to(HERE.parent)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def cache_dir(cfg: dict, content_seed: int, scale: int,
              root: Path | None = None) -> Path:
    root = HERE / "cache" if root is None else Path(root)
    return root / (f"{cfg['name']}-{content_seed}-{scale}-"
                   f"{writer_hash(cfg)}")


def member(obj: bytes, name: str, level: int) -> bytes:
    """`obj` as one gzip member, as gzip.GzipFile writes a named file at
    `level`: FNAME set, mtime 0."""
    buf = io.BytesIO()
    with gzip.GzipFile(filename=name, mode="wb", compresslevel=level,
                       fileobj=buf, mtime=0) as f:
        f.write(obj)
    return buf.getvalue()


def build(cfg: dict, traffic: dict, scale: int,
          root: Path | None = None) -> None:
    """Write the members of every content seed whose cache is not ready."""
    listed = traffic["objects"]
    names = [o["name"] for o in inputs.objects(listed)]
    todo = [cs for cs in traffic["content_seeds"]
            if not ready(cache_dir(cfg, cs, scale, root), len(names))]
    if not todo:
        return

    def write(cs: int, i: int, obj: bytes) -> None:
        where = cache_dir(cfg, cs, scale, root)
        tmp = where / f"obj{i}.{os.getpid()}.tmp"
        tmp.write_bytes(member(obj, names[i], cfg["compresslevel"]))
        os.replace(tmp, where / f"obj{i}.gz")

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        jobs = []
        for cs in todo:
            cache_dir(cfg, cs, scale, root).mkdir(parents=True, exist_ok=True)
            for i, obj in enumerate(inputs.make(cs, scale, listed)):
                jobs.append(pool.submit(write, cs, i, obj))
        for j in jobs:
            j.result()


def ready(where: Path, n: int) -> bool:
    return all((where / f"obj{i}.gz").exists() for i in range(n))


def members(cfg: dict, traffic: dict, content_seed: int, scale: int = 1,
            root: Path | None = None) -> list[bytes]:
    """The members of `content_seed`, one of the traffic's content seeds,
    in the objects' order; those of every content seed are written on the
    first run in a checkout."""
    build(cfg, traffic, scale, root)
    where = cache_dir(cfg, content_seed, scale, root)
    return [(where / f"obj{i}.gz").read_bytes()
            for i in range(len(inputs.objects(traffic["objects"])))]
