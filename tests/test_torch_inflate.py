"""Port parity: the host inflater (decode/inflate.py) against the JAX
package's Python inflater on CPython zlib streams, and the same error for
each malformed stream. Outputs are bytes and bit positions: exact
equality. The JAX side runs its Python path (`_inflate_raw_py`, and
`zlib_decompress` with the native runtime switched off), so these tests
never build the JAX package's native library."""
import zlib

import numpy as np
import pytest
import torch

from deflate_compression_tpu import native_bridge as jnb
from deflate_compression_tpu.decode import inflate as jinf
from deflate_compression_tpu.utils.errors import DeflateError as JaxDeflateError
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch import native_bridge as tnb
from deflate_compression_tpu_torch.decode import inflate as tinf
from deflate_compression_tpu_torch.utils.errors import DeflateError

torch.set_num_threads(1)

RAW = (corpus.sample("text", 24_000, seed=5).tobytes()
       + corpus.sample("rgb", 6_000, seed=5).tobytes()
       + corpus.sample("random", 3_000, seed=5).tobytes()
       + bytes(5_000) + corpus.sample("periodic", 4_000, seed=5).tobytes())


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    monkeypatch.setattr(jnb, "available", lambda: False)


def _zlib(level=6, strategy=zlib.Z_DEFAULT_STRATEGY, wbits=15, flush_every=0,
          flush=zlib.Z_SYNC_FLUSH, data=RAW):
    co = zlib.compressobj(level, zlib.DEFLATED, wbits, 8, strategy)
    if not flush_every:
        return co.compress(data) + co.flush()
    out = b""
    for i in range(0, len(data), flush_every):
        out += co.compress(data[i:i + flush_every]) + co.flush(flush)
    return out + co.flush()


STREAMS = ([(f"level{lv}", {"level": lv}) for lv in range(10)]
           + [(name, {"strategy": getattr(zlib, name)})
              for name in ("Z_FILTERED", "Z_HUFFMAN_ONLY", "Z_RLE",
                           "Z_FIXED")]
           + [("sync_flush_7001", {"flush_every": 7001}),
              ("full_flush_12345", {"flush_every": 12345,
                                    "flush": zlib.Z_FULL_FLUSH}),
              ("wbits9", {"wbits": 9})])


@pytest.mark.parametrize("name,kw", STREAMS, ids=[s[0] for s in STREAMS])
def test_inflate_raw_matches_jax(name, kw):
    comp = _zlib(**kw)
    want, want_end = jinf._inflate_raw_py(comp, 16)
    assert want == RAW
    assert tinf.inflate_raw(comp, 16, prefer_native=False) == (want, want_end)
    assert tnb.available()
    assert tinf.inflate_raw(comp, 16) == (want, want_end)     # native
    assert tinf.zlib_decompress(comp) == RAW
    assert jinf.zlib_decompress(comp) == RAW


def test_zlib_decompress_python_path_matches_jax(monkeypatch):
    comp = _zlib(level=9)
    monkeypatch.setattr(tnb, "available", lambda: False)
    assert tinf.zlib_decompress(comp) == jinf.zlib_decompress(comp) == RAW
    assert tinf.inflate_raw(comp, 16) == jinf._inflate_raw_py(comp, 16)


def test_max_output_takes_python_path():
    comp = _zlib(level=1)
    with pytest.raises(DeflateError) as e:
        tinf.inflate_raw(comp, 16, max_output=1000)
    with pytest.raises(JaxDeflateError) as j:
        jinf.inflate_raw(comp, 16, max_output=1000)
    assert e.value.name == j.value.name == "E_SIZE"
    assert tinf.inflate_raw(comp, 16, max_output=len(RAW))[0] == RAW


# ---------------------------------------------------------------- errors

def _window_violation():
    """A zlib stream that declares a 512-byte window (CINFO=1) but uses
    distances beyond it, its adler32 footer valid."""
    pat = b"The quick brown fox jumps over the lazy dog 0123456789!"
    data = pat * 20 + bytes(np.random.default_rng(3).integers(
        0, 256, 2000, dtype=np.uint8)) + pat * 20
    comp = zlib.compress(data, 9)
    cmf = (1 << 4) | 8
    flg = (31 - (cmf * 256) % 31) % 31
    return bytes([cmf, flg]) + comp[2:]


def _bad_cases():
    good = _zlib(level=6)
    stored = zlib.compress(RAW[:3000], 0)
    flip_adler = good[:-1] + bytes([good[-1] ^ 1])
    bad_fcheck = good[:1] + bytes([good[1] ^ 1]) + good[2:]
    cmf = 0x78
    flg = 0x20
    flg += (31 - ((cmf << 8) | flg) % 31) % 31
    fdict = bytes([cmf, flg]) + b"\x00\x00\x00\x01" + good[2:]
    # stored block: LEN kept, NLEN flipped
    lennlen = stored[:5] + bytes([stored[5] ^ 0xFF]) + stored[6:]
    # a distance past the output start: fixed block, literal 'a', then
    # length 3 at distance 2
    far = bytearray()
    bits = [1, 1, 0]                       # BFINAL, BTYPE=01 (LSB first)
    bits += [int(b) for b in format(0x30 + ord("a"), "08b")]
    bits += [int(b) for b in format(1, "07b")]        # symbol 257: length 3
    bits += [int(b) for b in format(1, "05b")]        # dist code 1: dist 2
    bits += [0] * 7                                   # EOB
    bits += [0] * (-len(bits) % 8)
    for i in range(0, len(bits), 8):
        far.append(sum(b << k for k, b in enumerate(bits[i:i + 8])))
    return {
        "bad_adler": (flip_adler, "zlib"),
        "bad_fcheck": (bad_fcheck, "zlib"),
        "fdict": (fdict, "zlib"),
        "lennlen": (lennlen, "zlib"),
        "far_distance": (bytes(far), "raw"),
        "truncated_mid_block": (good[:len(good) // 2], "zlib"),
        "truncated_raw": (good[2:len(good) // 3], "raw"),
        "window_violation": (_window_violation(), "zlib"),
        "reserved_btype": (bytes([0x07, 0x00]), "raw"),
        "short": (b"\x78\x9c\x03", "zlib"),
    }


def _outcome(fn, data):
    try:
        fn(data)
    except (DeflateError, JaxDeflateError) as e:
        return "DeflateError", e.name
    except Exception as e:                   # noqa: BLE001 (compared below)
        return type(e).__name__, None
    return "ok", None


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_errors_match_jax(case, monkeypatch):
    data, kind = _bad_cases()[case]
    if kind == "zlib":
        def port(d):
            return tinf.zlib_decompress(d)

        def jax(d):
            return jinf.zlib_decompress(d)
    else:
        def port(d):
            return tinf.inflate_raw(d, prefer_native=False)

        def jax(d):
            return jinf._inflate_raw_py(d)
    native = _outcome(port if kind == "zlib" else tinf.inflate_raw, data)
    assert native[0] == "DeflateError", native
    monkeypatch.setattr(tnb, "available", lambda: False)
    want = _outcome(jax, data)
    assert want[0] in ("DeflateError", "EOFError"), want
    assert _outcome(port, data) == want
