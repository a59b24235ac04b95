"""User-facing compress/decompress API (counterpart of
deflate_compression_tpu/models/codec.py).

`DeflateCodec` (raw RFC 1951), `ZlibCodec` (RFC 1950) and `GzipCodec`
(RFC 1952) cut the input into `config.shard_size` shards, encode each with
`format.deflate.encode_shard` on the codec's device, and join the
substreams (every non-final shard ends byte-aligned). With
`config.self_check` each shard's bytes are replayed on the host
(decode/verify.py) right after the card encodes them and before they are
committed. `decompress` inflates on the host (decode/inflate.py, native
where it builds). `compress_stream` and `compress_file` encode shard by
shard with O(shard) memory and hand out the encoder's decode index
(decode/index.py), which `decode.index.decompress_indexed` decodes on the
device.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..core import checksum
from ..device import pick_device
from ..decode.index import INDEX_STAT_FIELDS
from ..format import containers
from ..format.deflate import encode_shard, encode_shards, shard_bytes
from ..utils.config import DEFAULT_CONFIG, CodecConfig
from ..utils.errors import DeflateError
from ..utils.logging_util import LOGGER_NAME, MetricsRecorder, span, spanned

_LOG = logging.getLogger(f"{LOGGER_NAME}.models.codec")


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

    def to_csv(self) -> str:
        """Cumulative trace in the reference's format B
        (`bytes,compressed_bits`)."""
        lines = ["bytes,compressed_bits"]
        cb = 0
        cby = 0
        for bb, bits in zip(self.block_bytes, self.block_bits):
            cby += bb
            cb += bits
            lines.append(f"{cby},{cb}")
        return "\n".join(lines) + "\n"


@spanned("codec.self_check")
def _self_check_shard(shard_bytes: bytes, total_bits: int,
                      original: bytes, shard_idx: int) -> None:
    """Replay one shard's substream against a 32 KB ring on the host right
    after it is encoded and before its bytes are committed, so a bad token
    fails at its shard. Shards start fresh windows, so the replay is
    self-contained. Raises E_SELFCHECK."""
    from ..decode.verify import replay_stream
    try:
        out, _, _ = replay_stream(shard_bytes, 0, stop_at_bits=total_bits)
    except DeflateError as e:
        raise DeflateError(
            "E_SELFCHECK",
            f"self-check: shard {shard_idx} replay failed: {e}")
    if out != original:
        n = next((i for i, (a, b) in enumerate(zip(out, original))
                  if a != b), min(len(out), len(original)))
        raise DeflateError(
            "E_SELFCHECK",
            f"self-check: shard {shard_idx} reconstruction diverges at "
            f"byte {n} ({len(out)} vs {len(original)} bytes)")


class DeflateCodec:
    """Raw DEFLATE (RFC 1951) codec over byte strings: encode on one
    device (CUDA unless device="cpu" is passed), decode on the host."""

    def __init__(self, config: CodecConfig = DEFAULT_CONFIG, device=None):
        self.config = config
        self.device = pick_device(device)
        self.metrics = MetricsRecorder()

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
        S = cfg.shard_size
        nsh = -(-len(raw) // S)
        shards = encode_shards(raw, S, self.device,
                               num_candidates=cfg.num_candidates,
                               lazy=cfg.lazy, force_btype=cfg.force_btype)
        for s, r in enumerate(shards):
            # the first read of a shard's results: the host waits for the
            # card to finish the shard
            with span("codec.wait"):
                overflow = bool(r["sub_overflow"])
            if overflow:
                raise DeflateError("E_INDEX",
                                   f"shard {s}: sub-entry capacity overflow")
            with span("codec.unpack"):
                tb = int(r["total_bits"])
                sb = shard_bytes(r)
                part = raw[s * S:(s + 1) * S]
                if cfg.self_check:
                    _self_check_shard(sb, tb, part, s)
                parts.append(sb)
                bt = r["btype"].cpu().numpy()
                emitted = bt >= 0
                for t in range(3):
                    btc[t] += int((bt == t).sum())
                stats.n_blocks += int(emitted.sum())
                stats.n_tokens += int(r["n_tokens"])
                stats.n_matches += int(r["n_matches"])
                stats.tree_bits += int(r["tree_bits"].sum())
                stats.block_bits += \
                    r["block_bits"].cpu().numpy()[emitted].tolist()
                stats.block_bytes += \
                    r["block_bytes"].cpu().numpy()[emitted].tolist()
                self.metrics.record("shard_bytes", len(part))
                self.metrics.record("shard_bits", tb)
                _LOG.debug("shard %d/%d: %d bytes -> %d bits (%d blocks)",
                           s + 1, nsh, len(part), tb, int(emitted.sum()))
        with span("codec.unpack"):
            for bb, bits in zip(stats.block_bytes, stats.block_bits):
                self.metrics.record("block_bytes", bb)
                self.metrics.record("block_bits", bits)
            stats.btype_counts = tuple(btc)
        return parts, stats

    @spanned("codec.compress")
    def compress(self, data, return_stats: bool = False):
        raw = bytes(data)
        parts, stats = self._encode_shards(raw)
        with span("codec.wrap"):
            out = b"".join(parts)
        stats.output_bytes = len(out)
        return (out, stats) if return_stats else out

    def decompress(self, data: bytes) -> bytes:
        from ..decode.inflate import inflate_raw
        out, _ = inflate_raw(bytes(data))
        return out


class ZlibCodec(DeflateCodec):
    """zlib container (RFC 1950): CMF/FLG header + DEFLATE + big-endian
    adler32."""

    @spanned("codec.compress")
    def compress(self, data, return_stats: bool = False):
        raw = bytes(data)
        parts, stats = self._encode_shards(raw)
        with span("codec.adler32"):
            adler = checksum.adler32_np(np.frombuffer(raw, dtype=np.uint8))
        with span("codec.wrap"):
            out = containers.zlib_wrap(b"".join(parts), adler)
        stats.output_bytes = len(out)
        return (out, stats) if return_stats else out

    def decompress(self, data: bytes) -> bytes:
        from ..decode.inflate import zlib_decompress
        return zlib_decompress(bytes(data),
                               verify_adler=self.config.verify_checksums)


class GzipCodec(DeflateCodec):
    """gzip container (RFC 1952): header + DEFLATE + CRC-32 + ISIZE."""

    @spanned("codec.compress")
    def compress(self, data, return_stats: bool = False):
        raw = bytes(data)
        parts, stats = self._encode_shards(raw)
        with span("codec.crc32"):
            crc = checksum.crc32_np(raw)
        with span("codec.wrap"):
            out = containers.gzip_wrap(b"".join(parts), crc, len(raw))
        stats.output_bytes = len(out)
        return (out, stats) if return_stats else out

    def decompress(self, data: bytes) -> bytes:
        return containers.gzip_decompress(bytes(data))


def make_codec(config: CodecConfig = DEFAULT_CONFIG,
               device=None) -> DeflateCodec:
    return {"raw": DeflateCodec, "zlib": ZlibCodec,
            "gzip": GzipCodec}[config.container](config, device=device)


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
      config: honoured in full: the container ("raw", "zlib" or "gzip"),
        shard_size, the encoder options and self_check (each shard
        replayed on the host before it is yielded).
      index_sink: optional list receiving one (stats, total_bits, out_len)
        tuple per shard, stats as host numpy arrays, ready for
        decode.index.index_from_shards.
      device: where shards are encoded (the CUDA card unless "cpu").
    """
    cfg = config
    dev = pick_device(device)
    yield containers.container_header(cfg.container)

    def encode_one(part: bytes, s: int, final: bool) -> bytes:
        with span("codec.upload"):
            buf = np.zeros(cfg.shard_size, dtype=np.uint8)
            buf[:len(part)] = np.frombuffer(part, dtype=np.uint8)
            x = torch.from_numpy(buf).to(dev)
        r = encode_shard(x, len(part), final,
                         num_candidates=cfg.num_candidates, lazy=cfg.lazy,
                         force_btype=cfg.force_btype)
        with span("codec.wait"):
            overflow = bool(r["sub_overflow"])
        if overflow:
            raise DeflateError("E_INDEX",
                               f"shard {s}: sub-entry capacity overflow")
        with span("codec.unpack"):
            tb = int(r["total_bits"])
            sb = shard_bytes(r)
            if cfg.self_check:
                _self_check_shard(sb, tb, part, s)
            if index_sink is not None:
                stats = {k: r[k].cpu().numpy() for k in INDEX_STAT_FIELDS}
                index_sink.append((stats, tb, len(part)))
        return sb

    adler = 1
    crc = 0
    total_in = 0
    pending = None
    s = 0
    for chunk in _iter_shard_chunks(src, cfg.shard_size):
        if pending is not None:
            yield encode_one(pending, s, False)
            s += 1
        pending = chunk
        if cfg.container == "zlib":
            with span("codec.adler32"):
                adler = checksum.adler32_np(np.frombuffer(chunk, np.uint8),
                                            adler)
        elif cfg.container == "gzip":
            with span("codec.crc32"):
                crc = checksum.crc32_np(chunk, crc)
        total_in += len(chunk)
    if pending is not None:
        yield encode_one(pending, s, True)
    else:
        yield b"\x01\x00\x00\xff\xff"      # empty input: final stored block
    if cfg.container == "zlib":
        yield containers.zlib_footer(adler)
    elif cfg.container == "gzip":
        yield containers.gzip_footer(crc, total_in)


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
