"""deflate-compression-tpu, ported to PyTorch: the shard encoder and the
indexed decoder on a CUDA card.

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

Covered: `encode_shard` for shards up to 1 MB, the raw and zlib codecs'
`compress`, `compress_stream` / `compress_file` with the encoder's index,
and the indexed device decoder (`decode_blocks`, `decode_blocks_batch`,
`decompress_indexed`, `build_index`). Not yet ported: the codecs' host
`decompress`, gzip, the self-check, the CLI and shards over 1 MB.
"""

__all__ = ["CodecConfig", "DeflateError", "CompressStats", "DeflateCodec",
           "ZlibCodec", "make_codec", "compress_stream", "compress_file", "DecodeIndex",
           "build_index", "index_from_shards", "decompress_indexed"]


def __getattr__(name):
    if name == "CodecConfig":
        from .utils.config import CodecConfig
        return CodecConfig
    if name == "DeflateError":
        from .utils.errors import DeflateError
        return DeflateError
    if name in ("CompressStats", "DeflateCodec", "ZlibCodec", "make_codec",
                "compress_stream", "compress_file"):
        from .models import codec
        return getattr(codec, name)
    if name in ("DecodeIndex", "build_index", "index_from_shards",
                "decompress_indexed"):
        from .decode import index
        return getattr(index, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
