"""A gzip member read through the indexed decode: `decompress_gzip_indexed`
and the CRC-32 and ISIZE checks of `decompress_indexed`, on the CPU against
CPython's gzip and zlib; headers with FEXTRA, FCOMMENT and FHCRC; altered
members refused; the spans under a CPU profiler; the CLI's `decompress
--index` on a member with the host CRC never called; and, on a card, one
CRC-32 launch a group (these skip without one). This file imports no JAX.
"""
import gzip
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deflate_compression_tpu_torch import cli as tcli
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.core import checksum as CK
from deflate_compression_tpu_torch.decode import index as IDX
from deflate_compression_tpu_torch.format.containers import gzip_parse_header
from deflate_compression_tpu_torch.utils.errors import DeflateError
from deflate_compression_tpu_torch.utils.logging_util import SPAN_PREFIX

torch.set_num_threads(1)

G = 1 << 16                                      # the groups' output bytes


def member(raw: bytes, name: str = "obj", level: int = 9) -> bytes:
    """`raw` as CPython's gzip writes a named file: FNAME, mtime 0."""
    buf = io.BytesIO()
    with gzip.GzipFile(filename=name, mode="wb", compresslevel=level,
                       fileobj=buf, mtime=0) as f:
        f.write(raw)
    return buf.getvalue()


def index_of(m: bytes, native: bool = True) -> IDX.DecodeIndex:
    return IDX.build_index(m[gzip_parse_header(m):], prefer_native=native)


RAW = corpus.build_corpus(250_000, seed=21)
M = member(RAW)


KINDS = ("text", "cpp", "random", "periodic", "zeros", "rgb", "mixed")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_member_of_each_kind(kind, native):
    """About 600 KB in 64 KiB groups, each group after the first starting
    in the window of the one before, against CPython's inflater."""
    raw = corpus.sample(kind, 600_000, seed=len(kind)).tobytes()
    m = member(raw, kind)
    idx = index_of(m, native)
    assert idx.out_len // G >= 9
    assert IDX.decompress_gzip_indexed(m, idx, shard_out=G, device="cpu") \
        == zlib.decompress(m, 31) == raw


def test_native_and_python_index_agree():
    a, b = index_of(M, True), index_of(M, False)
    assert a.to_bytes() == b.to_bytes()


def _header(flags: int, extra: bytes = b"", name: bytes = b"",
            comment: bytes = b"") -> bytes:
    h = b"\x1f\x8b\x08" + bytes([flags]) + b"\0\0\0\0\x02\xff"
    if flags & 0x04:
        h += struct.pack("<H", len(extra)) + extra
    if flags & 0x08:
        h += name + b"\0"
    if flags & 0x10:
        h += comment + b"\0"
    if flags & 0x02:
        h += struct.pack("<H", zlib.crc32(h) & 0xFFFF)
    return h


@pytest.mark.parametrize("flags,extra,name,comment", [
    (0x04, b"AB\x02\x00xy", b"", b""),
    (0x10, b"", b"", b"a comment"),
    (0x02, b"", b"", b""),
    (0x04 | 0x08 | 0x10 | 0x02, b"RA\x03\x00zzz", b"name.tar", b"c"),
])
def test_header_fields(flags, extra, name, comment):
    raw = RAW[:90_000]
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    body = c.compress(raw) + c.flush()
    m = (_header(flags, extra, name, comment) + body
         + struct.pack("<II", zlib.crc32(raw), len(raw)))
    assert gzip.decompress(m) == raw
    idx = index_of(m)
    assert IDX.decompress_gzip_indexed(m, idx, shard_out=G,
                                       device="cpu") == raw


def _stored_byte(m: bytes, idx) -> int:
    """The member offset of the first stored block's first payload
    byte."""
    head = gzip_parse_header(m)
    b = int(np.flatnonzero(idx.btype == 0)[0])
    at = (int(idx.bit_base[b]) + 3 + 7) // 8
    return head + at + 4


@pytest.mark.parametrize("what,code", [("crc32", "E_ADLER"),
                                       ("isize", "E_SIZE"),
                                       ("stored", "E_ADLER")])
def test_altered_member_raises(what, code):
    """Random bytes, so level 9 writes stored blocks: a payload byte
    altered still decodes, to other bytes, which the CRC-32 catches."""
    raw = corpus.sample("random", 150_000, seed=4).tobytes()
    m = member(raw)
    idx = index_of(m)
    bad = bytearray(m)
    at = {"crc32": len(m) - 8, "isize": len(m) - 1}.get(what) \
        or _stored_byte(m, idx)
    bad[at] ^= 0x40
    with pytest.raises(DeflateError) as e:
        IDX.decompress_gzip_indexed(bytes(bad), idx, shard_out=G,
                                    device="cpu")
    assert e.value.name == code


def test_truncated_footer_raises():
    with pytest.raises(DeflateError) as e:
        IDX.decompress_gzip_indexed(M[:14], index_of(M), device="cpu")
    assert e.value.name == "E_TRUNC"


def test_crc_is_read_once_after_the_last_group(monkeypatch):
    """Each group chains its CRC-32 from the last one's tensor; only the
    join reads the value."""
    inits, calls = [], []
    orig = CK.crc32_torch

    def spy(data, valid_len, init=None):
        inits.append(init)
        out = orig(data, valid_len, init)
        calls.append(out)
        return out
    monkeypatch.setattr(CK, "crc32_torch", spy)
    idx = index_of(M)
    assert IDX.decompress_gzip_indexed(M, idx, shard_out=G,
                                       device="cpu") == RAW
    assert len(calls) >= 3 and inits[0] == 0
    assert all(i is c for i, c in zip(inits[1:], calls))


def _spans(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(SPAN_PREFIX) and \
                str(e.device_type()).endswith("CPU"):
            t0 = e.start_ns()
            out.append((e.name()[len(SPAN_PREFIX):], t0,
                        t0 + e.duration_ns()))
    return out


def _parent(spans, k):
    name, t0, t1 = spans[k]
    inside = [(b - a, n) for i, (n, a, b) in enumerate(spans)
              if i != k and a <= t0 and t1 <= b]
    return min(inside)[1] if inside else None


def test_spans_under_the_profiler():
    idx = index_of(M)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert IDX.decompress_gzip_indexed(M, idx, shard_out=G,
                                           device="cpu") == RAW
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    groups = names.count("index.group")
    assert groups >= 3
    want = {"index.gzip": (1, None), "index.decompress": (1, "index.gzip"),
            "index.crc32": (groups, "index.decompress"),
            "checksum.crc32": (groups, "index.crc32"),
            "index.join": (1, "index.decompress")}
    for name, (count, parent) in want.items():
        assert names.count(name) == count, name
        for k, (n, _, _) in enumerate(spans):
            if n == name:
                assert _parent(spans, k) == parent, name
    assert "index.adler32" not in names


def _cli(tmp_path, m: bytes, *extra):
    (tmp_path / "in.gz").write_bytes(m)
    (tmp_path / "in.dcx").write_bytes(index_of(M).to_bytes())
    return tcli.main(["decompress", str(tmp_path / "in.gz"), "-o",
                      str(tmp_path / "out"), "--index",
                      str(tmp_path / "in.dcx"), "--device", "cpu", *extra])


def test_cli_index_decode_never_calls_the_host_crc(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host crc32_np called")
    monkeypatch.setattr(CK, "crc32_np", refuse)
    assert _cli(tmp_path, M) == 0
    assert (tmp_path / "out").read_bytes() == RAW
    assert _cli(tmp_path, M, "--no-verify") == 0
    assert (tmp_path / "out").read_bytes() == RAW


@pytest.mark.parametrize("at", [-8, -1])
def test_cli_index_decode_errors_as_before(tmp_path, at):
    bad = bytearray(M)
    bad[at] ^= 1
    with pytest.raises(DeflateError) as e:
        _cli(tmp_path, bytes(bad))
    assert e.value.name == "E_ADLER"
    assert str(e.value).endswith("gzip CRC/ISIZE mismatch")
    assert _cli(tmp_path, bytes(bad), "--no-verify") == 0


# ------------------------------------------------------------- on a card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the path is verified by "
                    "chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_crc32_launch_a_group_on_the_card(cuda):
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import crc32 as CR
    raw = corpus.build_corpus(3_000_000, seed=5)
    m = member(raw)
    idx = index_of(m)
    before = [CR.crc32.launches, BT.build_tables.launches]
    assert IDX.decompress_gzip_indexed(m, idx, shard_out=1 << 20,
                                       device="cuda") == raw
    groups = BT.build_tables.launches - before[1]
    assert groups >= 3
    assert CR.crc32.launches - before[0] == groups
    bad = bytearray(m)
    bad[-6] ^= 2
    with pytest.raises(DeflateError) as e:
        IDX.decompress_gzip_indexed(bytes(bad), idx, device="cuda")
    assert e.value.name == "E_ADLER"
