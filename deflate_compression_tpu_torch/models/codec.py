"""User-facing compress API (counterpart of
deflate_compression_tpu/models/codec.py).

`DeflateCodec` (raw RFC 1951) and `ZlibCodec` (RFC 1950 container) cut the
input into `config.shard_size` shards, encode each with
`format.deflate.encode_shard` on the codec's device, and join the
substreams (every non-final shard ends byte-aligned). `compress_stream`
and `compress_file` encode shard by shard with O(shard) memory and hand
out the encoder's decode index (decode/index.py), which
`decode.index.decompress_indexed` decodes on the device. Not ported yet:
the codecs' host `decompress`, the gzip codec and the self-check.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import checksum
from ..device import pick_device
from ..decode.index import INDEX_STAT_FIELDS
from ..format import containers
from ..format.deflate import encode_shard, encode_shards, shard_bytes
from ..utils.config import DEFAULT_CONFIG, CodecConfig
from ..utils.errors import DeflateError


@dataclasses.dataclass
class CompressStats:
    """Per-block compression telemetry (same fields as the JAX package's
    CompressStats)."""
    input_bytes: int = 0
    output_bytes: int = 0
    n_blocks: int = 0
    n_tokens: int = 0
    n_matches: int = 0
    btype_counts: tuple = (0, 0, 0)       # stored / fixed / dynamic
    tree_bits: int = 0
    block_bits: list = dataclasses.field(default_factory=list)
    block_bytes: list = dataclasses.field(default_factory=list)

    @property
    def rate_bits_per_byte(self) -> float:
        return 8.0 * self.output_bytes / max(1, self.input_bytes)


class DeflateCodec:
    """Raw DEFLATE (RFC 1951) encoder over byte strings, on one device
    (CUDA unless device="cpu" is passed)."""

    def __init__(self, config: CodecConfig = DEFAULT_CONFIG, device=None):
        if config.self_check:
            raise NotImplementedError("self_check is not ported yet")
        self.config = config
        self.device = pick_device(device)

    def _encode_shards(self, raw: bytes):
        cfg = self.config
        stats = CompressStats(input_bytes=len(raw))
        if not raw:
            stats.n_blocks = 1
            stats.btype_counts = (1, 0, 0)
            stats.block_bits = [40]
            stats.block_bytes = [0]
            return [b"\x01\x00\x00\xff\xff"], stats   # final empty stored
        parts = []
        btc = [0, 0, 0]
        shards = encode_shards(raw, cfg.shard_size, self.device,
                               num_candidates=cfg.num_candidates,
                               lazy=cfg.lazy, force_btype=cfg.force_btype)
        for s, r in enumerate(shards):
            if bool(r["sub_overflow"]):
                raise DeflateError("E_INDEX",
                                   f"shard {s}: sub-entry capacity overflow")
            parts.append(shard_bytes(r))
            bt = r["btype"].cpu().numpy()
            emitted = bt >= 0
            for t in range(3):
                btc[t] += int((bt == t).sum())
            stats.n_blocks += int(emitted.sum())
            stats.n_tokens += int(r["n_tokens"])
            stats.n_matches += int(r["n_matches"])
            stats.tree_bits += int(r["tree_bits"].sum())
            stats.block_bits += r["block_bits"].cpu().numpy()[emitted].tolist()
            stats.block_bytes += r["block_bytes"].cpu().numpy()[emitted].tolist()
        stats.btype_counts = tuple(btc)
        return parts, stats

    def compress(self, data, return_stats: bool = False):
        raw = bytes(data)
        parts, stats = self._encode_shards(raw)
        out = b"".join(parts)
        stats.output_bytes = len(out)
        return (out, stats) if return_stats else out


class ZlibCodec(DeflateCodec):
    """zlib container (RFC 1950): CMF/FLG header + DEFLATE + big-endian
    adler32."""

    def compress(self, data, return_stats: bool = False):
        raw = bytes(data)
        parts, stats = self._encode_shards(raw)
        adler = checksum.adler32_np(np.frombuffer(raw, dtype=np.uint8))
        out = containers.zlib_wrap(b"".join(parts), adler)
        stats.output_bytes = len(out)
        return (out, stats) if return_stats else out


def make_codec(config: CodecConfig = DEFAULT_CONFIG,
               device=None) -> DeflateCodec:
    if config.container == "gzip":
        raise NotImplementedError("the gzip codec is not ported yet")
    return {"raw": DeflateCodec, "zlib": ZlibCodec}[config.container](
        config, device=device)


# --------------------------------------------------------------- streaming
def _iter_shard_chunks(src, size: int):
    """Yield successive chunks of exactly `size` bytes (the last may be
    short) from a file-like object or an iterable of bytes."""
    if hasattr(src, "read"):
        it = iter(lambda: src.read(size), b"")
    else:
        it = iter(src)
    buf = bytearray()
    for piece in it:
        buf += piece
        while len(buf) >= size:
            yield bytes(buf[:size])
            del buf[:size]
    if buf:
        yield bytes(buf)


def compress_stream(src, config: CodecConfig = DEFAULT_CONFIG,
                    index_sink: list | None = None, device=None):
    """Streaming encode (the JAX package's compress_stream): yield the
    container header, each shard's substream as soon as it is encoded, and
    the footer, holding O(shard) memory. Every non-final shard ends
    byte-aligned, so its bytes are final when yielded.

    Args:
      src: file-like object (.read) or iterable of bytes chunks.
      config: container "raw" or "zlib" (gzip and self_check are not
        ported yet and raise NotImplementedError), shard_size and the
        encoder options.
      index_sink: optional list receiving one (stats, total_bits, out_len)
        tuple per shard, stats as host numpy arrays, ready for
        decode.index.index_from_shards.
      device: where shards are encoded (the CUDA card unless "cpu").
    """
    cfg = config
    if cfg.container == "gzip":
        raise NotImplementedError("the gzip codec is not ported yet")
    if cfg.self_check:
        raise NotImplementedError("self_check is not ported yet")
    dev = pick_device(device)
    yield containers.container_header(cfg.container)

    def encode_one(part: bytes, s: int, final: bool) -> bytes:
        buf = np.zeros(cfg.shard_size, dtype=np.uint8)
        buf[:len(part)] = np.frombuffer(part, dtype=np.uint8)
        r = encode_shard(torch.from_numpy(buf).to(dev), len(part), final,
                         num_candidates=cfg.num_candidates, lazy=cfg.lazy,
                         force_btype=cfg.force_btype)
        if bool(r["sub_overflow"]):
            raise DeflateError("E_INDEX",
                               f"shard {s}: sub-entry capacity overflow")
        if index_sink is not None:
            stats = {k: r[k].cpu().numpy() for k in INDEX_STAT_FIELDS}
            index_sink.append((stats, int(r["total_bits"]), len(part)))
        return shard_bytes(r)

    adler = 1
    pending = None
    s = 0
    for chunk in _iter_shard_chunks(src, cfg.shard_size):
        if pending is not None:
            yield encode_one(pending, s, False)
            s += 1
        pending = chunk
        if cfg.container == "zlib":
            adler = checksum.adler32_np(np.frombuffer(chunk, np.uint8), adler)
    if pending is not None:
        yield encode_one(pending, s, True)
    else:
        yield b"\x01\x00\x00\xff\xff"      # empty input: final stored block
    if cfg.container == "zlib":
        yield containers.zlib_footer(adler)


def compress_file(in_path: str, out_path: str,
                  config: CodecConfig = DEFAULT_CONFIG,
                  index_path: str | None = None, device=None) -> int:
    """Stream-compress a file to a file with O(shard) memory; optionally
    write the encoder's .dcx decode-index sidecar. Returns the compressed
    byte count."""
    from ..decode.index import index_from_shards
    sink = [] if index_path else None
    n = 0
    with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
        for piece in compress_stream(fin, config, index_sink=sink,
                                     device=device):
            fout.write(piece)
            n += len(piece)
    if index_path:
        idx = index_from_shards([t[0] for t in sink], [t[1] for t in sink],
                                [t[2] for t in sink])
        with open(index_path, "wb") as f:
            f.write(idx.to_bytes())
    return n
