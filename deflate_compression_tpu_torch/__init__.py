"""deflate-compression-tpu, ported to PyTorch: the shard encoder and the
indexed decoder on a CUDA card, with the codec's host decode, verifier,
PNG decoder and trace around them.

This package is the PyTorch counterpart of `deflate_compression_tpu` (the
JAX package, which stays the reference). Module names mirror the JAX
package so each counterpart is easy to find (the decoder's
`decode/tpu_inflate.py` is `decode/device_inflate.py` here):

    from deflate_compression_tpu_torch import (
        CodecConfig, ZlibCodec, compress_stream, decompress_indexed,
        index_from_shards)
    blob = ZlibCodec(CodecConfig(), device="cuda").compress(data)

    sink = []
    blob = b"".join(compress_stream([data], CodecConfig(), index_sink=sink))
    index = index_from_shards(*zip(*sink))
    assert decompress_indexed(blob[2:-4], index) == data

Parameters carried across: the codec has no weights and no random state.
Its only state is the `CodecConfig` object and the fixed RFC 1951 tables.
The port keeps its own copies of both (`utils/config.py`,
`format/constants.py`) and of its error types (`utils/errors.py`), with the
JAX package's fields, values and codes; it imports nothing of the JAX
package. `build_index` calls the repository's native C++ index pass
(`native/deflate_native.cpp`), which the port builds into its own `build/`
directory (`native_bridge.py`), where a compiler is found. The decoder's
state is the stream words and the decode index, and the .dcx index bytes
are the JAX package's.

Device stages are plain PyTorch on int64 tensors (u32 values carried in
int64, see `core/u32.py`), except the hand-written CUDA kernels in `csrc/`:
the per-tile symbol histogram of the encoder (`ops/histogram.py`), the
decoder's phase-B symbol decode (`ops/decode_symbols.py`) and its lanes'
block-flag gather (`ops/lut_gather.py`).
Runs on `device="cpu"` take each kernel's plain PyTorch version; a CUDA
tensor always goes through the kernel.

Covered: `encode_shard` for shards of any multiple of 32 KB; the raw, zlib
and gzip codecs' `compress` on the card and `decompress` on the host
(`decode/inflate.py`, the native inflater where it builds), with the
self-check and the codec's metrics; `compress_stream` / `compress_file`
with the encoder's index; the indexed device decoder (`decode_blocks`,
`decode_blocks_batch`, `decompress_indexed`, `build_index`); the stream
verifier (`decode/verify.py`), CRC-32 and the gzip container, the PNG
decoder (`png/decoder.py`), the adaptive Huffman tree (`core/aht.py`) and
the per-symbol trace (`utils/trace.py`, tokenized on the card). Host
modules are copies of the JAX package's, with its names and outputs. Not
yet ported: the distributed encode with checkpoint/resume, the CLI and the
port's bench.
"""

__all__ = ["CodecConfig", "DeflateError", "PngError", "CompressStats",
           "DeflateCodec", "ZlibCodec", "GzipCodec", "make_codec",
           "compress_stream", "compress_file", "DecodeIndex", "build_index",
           "index_from_shards", "decompress_indexed", "verify_stream",
           "png_decode", "per_symbol_trace_csv"]

_HOMES = {
    "CodecConfig": "utils.config", "DeflateError": "utils.errors",
    "PngError": "utils.errors", "verify_stream": "decode.verify",
    "png_decode": "png.decoder", "per_symbol_trace_csv": "utils.trace",
    **dict.fromkeys(("CompressStats", "DeflateCodec", "ZlibCodec",
                     "GzipCodec", "make_codec", "compress_stream",
                     "compress_file"), "models.codec"),
    **dict.fromkeys(("DecodeIndex", "build_index", "index_from_shards",
                     "decompress_indexed"), "decode.index"),
}


def __getattr__(name):
    if name in _HOMES:
        import importlib
        return getattr(importlib.import_module(f".{_HOMES[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
