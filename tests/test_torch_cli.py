"""Port parity: the command line (cli.py, `python -m
deflate_compression_tpu_torch`) against the JAX package's on the CPU. The
same argv goes through both packages' `main` (the port's with `--device
cpu` where a subcommand takes a device, in a directory of its own);
return codes, every file written and the printed text must be identical,
apart from the encode rate of `compress -v`, a time.

Inputs are made from a seed by `corpus.build_corpus`, and a PNG is built
here with zlib and struct."""
import re
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from deflate_compression_tpu import cli as jcli
from deflate_compression_tpu import native_bridge as jnb
from deflate_compression_tpu_torch import cli as tcli
from deflate_compression_tpu_torch import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
S = "32768"
RAW = corpus.build_corpus(2 * 32768 + 9_000, seed=21)
DEVICE_CMDS = ("compress", "decompress", "trace")


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    monkeypatch.setattr(jnb, "available", lambda: False)


def png_bytes() -> bytes:
    """A 12 x 9 RGB8 PNG with a tEXt chunk, rows filtered None..Paeth."""
    px = np.random.default_rng(5).integers(0, 256, (9, 12, 3), np.uint8)

    def chunk(name, payload):
        return (struct.pack(">I", len(payload)) + name + payload
                + struct.pack(">I", zlib.crc32(name + payload)))
    rows = b"".join(bytes([0]) + r.tobytes() for r in px)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 12, 9, 8, 2, 0, 0, 0))
            + chunk(b"tEXt", b"Comment\x00made by the CLI parity test")
            + chunk(b"IDAT", zlib.compress(rows, 9)) + chunk(b"IEND", b""))


_RATE = re.compile(r"[0-9.]+ MB/s|\([0-9.]+s\)")


def _run(main, argv, d: Path, capsys):
    argv = [a.replace("{d}", str(d)) for a in argv]
    rc = main(argv)
    cap = capsys.readouterr()
    text = (cap.out + "\n--\n" + cap.err).replace(str(d), "{d}")
    files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    return rc, _RATE.sub("<rate>", text), files


@pytest.fixture
def both(tmp_path, capsys):
    """run(argv, inputs) -> (JAX result, port result); each is (return
    code, printed text, the directory's files) of one run in a directory
    holding `inputs`. '{d}' in argv is that directory."""
    def run(argv, inputs):
        res = []
        for name, main in (("jax", jcli.main), ("port", tcli.main)):
            d = tmp_path / name
            d.mkdir(exist_ok=True)
            for k, v in inputs.items():
                (d / k).write_bytes(v)
            a = list(argv)
            if name == "port" and a[0] in DEVICE_CMDS:
                a += ["--device", "cpu"]
            res.append(_run(main, a, d, capsys))
        return res
    return run


COMPRESS = {
    "zlib_v_stats_index": ["-v", "--stats", "{d}/s.csv",
                           "--index", "{d}/x.dcx"],
    "gzip_index": ["--container", "gzip", "--index", "{d}/x.dcx"],
    "raw_fixed_greedy": ["--container", "raw", "--btype", "fixed",
                         "--greedy", "--candidates", "8"],
    "stream_index": ["--stream", "--index", "{d}/x.dcx", "-v"],
    "self_check": ["--self-check", "-v"],
    "distributed_index": ["--distributed", "--index", "{d}/x.dcx",
                          "--self-check"],
    "stream_with_stats_refused": ["--stream", "--stats", "{d}/s.csv"],
}


@pytest.mark.parametrize("case", sorted(COMPRESS))
def test_compress_matches_jax(both, case):
    j, p = both(["compress", "{d}/in.bin", "-o", "{d}/out", "--shard-size",
                 S, *COMPRESS[case]], {"in.bin": RAW})
    assert p == j
    if p[0] == 0 and "raw" not in case:
        body = p[2]["out"]
        assert zlib.decompress(body, wbits=31 if "gzip" in case
                               else 15) == RAW


def _compressed(container: str, index: bool) -> dict:
    """Port-made inputs for the decoding subcommands."""
    from deflate_compression_tpu_torch import (CodecConfig, build_index,
                                               make_codec)
    from deflate_compression_tpu_torch.format.containers import \
        gzip_parse_header
    blob = make_codec(CodecConfig(shard_size=32768, container=container),
                      device="cpu").compress(RAW)
    files = {"in.z": blob, "orig.bin": RAW}
    if index:
        start = {"zlib": 2, "raw": 0}[container] if container != "gzip" \
            else gzip_parse_header(blob)
        files["in.dcx"] = build_index(blob[start:], prefer_native=False
                                      ).to_bytes()
    return files


@pytest.mark.parametrize("container", ["zlib", "gzip", "raw"])
@pytest.mark.parametrize("index", [False, True])
def test_decompress_matches_jax(both, container, index):
    argv = ["decompress", "{d}/in.z", "-o", "{d}/out"]
    if index:
        argv += ["--index", "{d}/in.dcx"]
    j, p = both(argv, _compressed(container, index))
    assert p == j and p[0] == 0
    assert p[2]["out"] == RAW


def test_decompress_index_adler_mismatch_raises_like_jax(tmp_path):
    from deflate_compression_tpu.utils.errors import DeflateError as JErr
    from deflate_compression_tpu_torch.utils.errors import DeflateError
    files = _compressed("zlib", True)
    blob = bytearray(files["in.z"])
    blob[-1] ^= 1
    for k, v in {**files, "in.z": bytes(blob)}.items():
        (tmp_path / k).write_bytes(v)
    argv = ["decompress", str(tmp_path / "in.z"), "-o",
            str(tmp_path / "out"), "--index", str(tmp_path / "in.dcx")]
    with pytest.raises(DeflateError) as e:
        tcli.main(argv + ["--device", "cpu"])
    with pytest.raises(JErr) as je:
        jcli.main(argv)
    assert (e.value.name, str(e.value)) == (je.value.name, str(je.value))


@pytest.mark.parametrize("args", [[], ["--bits"],
                                  ["--bits", "--bits-per-line", "3"]])
@pytest.mark.parametrize("container", ["zlib", "gzip"])
def test_inspect_matches_jax(both, container, args):
    j, p = both(["inspect", "{d}/in.z", *args],
                _compressed(container, False))
    assert p == j and p[0] == 0
    assert "block 0" in p[1] or "--bits" in args


@pytest.mark.parametrize("container", ["zlib", "gzip", "raw"])
def test_verify_matches_jax(both, container):
    j, p = both(["verify", "{d}/in.z", "--original", "{d}/orig.bin", "-v"],
                _compressed(container, False))
    assert p == j and p[0] == 0
    assert "OK: " in p[1]


def test_verify_flags_corruption_like_jax(both):
    files = _compressed("zlib", False)
    blob = bytearray(files["in.z"])
    blob[len(blob) // 2] ^= 0x40
    j, p = both(["verify", "{d}/in.z", "-v"], {"in.z": bytes(blob)})
    assert p == j and p[0] == 1


@pytest.mark.parametrize("args", [["--rgb-text"], ["--raw"], []])
def test_png_matches_jax(both, args):
    j, p = both(["png", "{d}/in.png", "-o", "{d}/out", *args],
                {"in.png": png_bytes()})
    assert p == j and p[0] == 0
    assert "12x9 truecolor 8-bit" in p[1]


@pytest.mark.parametrize("args", [[], ["--per-symbol", "--stride", "16",
                                       "--header-stride", "4"]])
def test_trace_matches_jax(both, args):
    j, p = both(["trace", "{d}/in.bin", "-o", "{d}/out", *args],
                {"in.bin": RAW[:20_000]})
    assert p == j and p[0] == 0
    assert p[2]["out"].splitlines()[-1].startswith(b"20000,")


def test_cli_default_device_is_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "in").write_bytes(RAW[:1000])
    for argv in (["compress", str(tmp_path / "in"), "-o",
                  str(tmp_path / "o")],
                 ["trace", str(tmp_path / "in"), "-o", str(tmp_path / "t")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv)


def test_python_m_entry_point(tmp_path):
    """`python -m deflate_compression_tpu_torch` in a process where jax and
    the JAX package cannot be imported."""
    src = tmp_path / "in.bin"
    src.write_bytes(RAW[:40_000])
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['deflate_compression_tpu'] = None; "
            "sys.argv = ['deflate_compression_tpu_torch'] + sys.argv[1:]; "
            "runpy.run_module('deflate_compression_tpu_torch', "
            "run_name='__main__')")
    res = subprocess.run(
        [sys.executable, "-c", code, "compress", str(src), "-o",
         str(tmp_path / "o.gz"), "--container", "gzip", "--shard-size", S,
         "--device", "cpu"], cwd=ROOT, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    import gzip
    assert gzip.decompress((tmp_path / "o.gz").read_bytes()) == RAW[:40_000]
