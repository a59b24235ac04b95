"""Guards of the PyTorch port: it runs where JAX and the JAX package are
absent, and it never moves to the CPU on its own."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deflate_compression_tpu_torch.device import pick_device

ROOT = Path(__file__).resolve().parent.parent

_NO_JAX = r"""
import sys, zlib
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["deflate_compression_tpu"] = None    # and so does the JAX package
import numpy as np
import deflate_compression_tpu_torch
from deflate_compression_tpu_torch import CodecConfig, DeflateError
from deflate_compression_tpu_torch.models.codec import ZlibCodec
data = (b"a jax-free encode of one 32 KB shard. " * 1000)[:32768]
blob = ZlibCodec(CodecConfig(shard_size=32768), device="cpu").compress(data)
assert zlib.decompress(blob) == data
from deflate_compression_tpu_torch.decode.index import (
    build_index, decompress_indexed, native_available)
from deflate_compression_tpu_torch.models.codec import compress_stream
sink = []
body = b"".join(compress_stream([data], CodecConfig(shard_size=32768,
                                                    container="raw"),
                                index_sink=sink, device="cpu"))
assert native_available()
idx = build_index(body)
py_idx = build_index(body, prefer_native=False)
assert idx.to_bytes() == py_idx.to_bytes()
assert decompress_indexed(body, idx, expected_adler=zlib.adler32(data),
                          device="cpu") == data
try:
    decompress_indexed(body, idx, expected_adler=zlib.adler32(data) ^ 1,
                       device="cpu")
except DeflateError:
    pass
else:
    raise AssertionError("adler mismatch not raised")
import gzip, struct
from deflate_compression_tpu_torch import (
    GzipCodec, make_codec, per_symbol_trace_csv, png_decode, verify_stream)
for container in ("raw", "zlib", "gzip"):
    codec = make_codec(CodecConfig(shard_size=32768, container=container),
                       device="cpu")
    comp = codec.compress(data)
    assert codec.decompress(comp) == data
    reports, checks = verify_stream(comp, data)
    assert reports and all(ok for _, ok, _ in checks), checks
assert gzip.decompress(comp) == data and isinstance(codec, GzipCodec)
px = np.random.default_rng(0).integers(0, 256, (5, 4, 4), dtype=np.uint8)
def chunk(name, payload):
    return (struct.pack(">I", len(payload)) + name + payload
            + struct.pack(">I", zlib.crc32(name + payload)))
rows = b"".join(b"\x00" + r.tobytes() for r in px)
png = (b"\x89PNG\r\n\x1a\n"
       + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 5, 8, 6, 0, 0, 0))
       + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
assert (png_decode(png).pixels == px).all()
csv = per_symbol_trace_csv(data[:4096], device="cpu", stride=64)
assert csv.splitlines()[-1].startswith("4096,")
import torch
from deflate_compression_tpu_torch.format.deflate import encode_shard, shard_bytes
big = np.frombuffer((data * 33)[:1_081_344], np.uint8).copy()
r = encode_shard(torch.from_numpy(big), big.size, True)
assert zlib.decompress(shard_bytes(r), wbits=-15) == big.tobytes()
assert sys.modules["jax"] is None
assert sys.modules["deflate_compression_tpu"] is None
assert not any(m.startswith(("jax.", "deflate_compression_tpu."))
               for m in sys.modules), "a blocked package's submodule"
print("NOJAX_OK", len(blob))
"""


def test_port_imports_and_encodes_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NOJAX_OK" in res.stdout


# `import jax`, `from jax...`, and the same of the JAX package (whose name
# is the port's without `_torch`)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|deflate_compression_tpu)(\.|\s|$)")


def test_port_sources_do_not_import_jax():
    for p in [ROOT / "chip_smoke.py", ROOT / "kernel_turns.py",
              *sorted((ROOT / "deflate_compression_tpu_torch").rglob("*.py"))]:
        for line in p.read_text().splitlines():
            assert not _FORBIDDEN.match(line), f"{p}: {line}"


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("from jax import numpy", True),
    ("    import jax.numpy as jnp", True),
    ("from deflate_compression_tpu.format import constants", True),
    ("from deflate_compression_tpu import native_bridge", True),
    ("import deflate_compression_tpu", True),
    ("from deflate_compression_tpu_torch.ops import histogram", False),
    ("import deflate_compression_tpu_torch", False),
    ("# from deflate_compression_tpu.x import y", False),
])
def test_source_scan_pattern(line, bad):
    assert bool(_FORBIDDEN.match(line)) == bad


def test_pick_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pick_device("cuda")
    with pytest.raises(RuntimeError):
        pick_device(None)              # the default is the card


def test_pick_device_cpu_only_when_asked():
    assert pick_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        pick_device("meta")


def test_codec_default_device_is_cuda(monkeypatch):
    from deflate_compression_tpu_torch.models.codec import ZlibCodec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ZlibCodec()


def test_gzip_codec_and_trace_default_device_is_cuda(monkeypatch):
    from deflate_compression_tpu_torch import GzipCodec, per_symbol_trace_csv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        GzipCodec()
    with pytest.raises(RuntimeError):
        per_symbol_trace_csv(b"tokenized on the card unless asked")


def test_kernel_wrappers_reject_other_devices():
    from deflate_compression_tpu_torch.ops.lut_gather import lut_gather
    tbl = torch.zeros(2048, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        lut_gather(tbl, torch.zeros(16, dtype=torch.int32, device="meta"))


def test_decompress_indexed_default_device_is_cuda(monkeypatch):
    from deflate_compression_tpu_torch.decode.index import (
        DecodeIndex, decompress_indexed)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = DecodeIndex(np.zeros(1, np.int64), np.zeros(1, np.int64),
                      np.zeros(1, np.uint8), 0)
    with pytest.raises(RuntimeError):
        decompress_indexed(b"\x01\x00\x00\xff\xff", idx)


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """A kernel that does not build raises; nothing falls back."""
    import shutil
    from deflate_compression_tpu_torch.ops import cuda_build
    src = tmp_path / "broken_kernel.cu"
    src.write_text("this is not CUDA\n")
    monkeypatch.setattr(cuda_build, "nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build(src)
    monkeypatch.undo()
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(src)
