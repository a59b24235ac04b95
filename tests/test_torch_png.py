"""Port parity: the PNG decoder (png/decoder.py) against the JAX package's
on PNGs built in the test from seeded numpy pixels with zlib and struct:
colour types 0/2/3/4/6, bit depths 1-16, the five filters, Adam7, PLTE and
tRNS, text and other ancillary chunks. Pixels, palette, metadata and
warnings compare exactly, and the pixels also against those the test
built. JAX's decoder runs its Python defilter and inflater."""
import struct
import zlib

import numpy as np
import pytest

from deflate_compression_tpu import native_bridge as jnb
from deflate_compression_tpu.png import decoder as jpng
from deflate_compression_tpu.utils.errors import PngError as JaxPngError
from deflate_compression_tpu_torch import native_bridge as tnb
from deflate_compression_tpu_torch.png import decoder as tpng
from deflate_compression_tpu_torch.utils.errors import PngError

SIG = b"\x89PNG\r\n\x1a\n"
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    monkeypatch.setattr(jnb, "available", lambda: False)


def chunk(name: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + name + payload
            + struct.pack(">I", zlib.crc32(name + payload)))


def _pack_row(samples: np.ndarray, depth: int) -> bytes:
    """(w, c) samples -> the row's bytes: MSB-first below 8 bits,
    big-endian at 16."""
    flat = samples.reshape(-1)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    bits = ((flat[:, None].astype(np.uint8) >> np.arange(depth - 1, -1, -1))
            & 1).reshape(-1)
    return np.packbits(bits).tobytes()


def _filter_row(x: np.ndarray, prev: np.ndarray, f: int, bpp: int):
    x16 = x.astype(np.int16)
    left = np.concatenate([np.zeros(bpp, np.int16), x16[:-bpp]])
    up = prev.astype(np.int16)
    ul = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
    if f == 0:
        pred = np.zeros_like(x16)
    elif f == 1:
        pred = left
    elif f == 2:
        pred = up
    elif f == 3:
        pred = (left + up) // 2
    else:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    return ((x16 - pred) & 0xFF).astype(np.uint8)


def build_png(px: np.ndarray, ct: int, depth: int, interlace: int = 0,
              filters=(0, 1, 2, 3, 4), extra_before=(), extra_after=(),
              palette=None, trns=None, seed=0, idat_parts=2) -> bytes:
    """A PNG of px (H, W, channels) with the filters cycled row by row."""
    h, w, c = px.shape
    bpp = max(1, c * depth // 8)
    rng = np.random.default_rng(seed)
    raw = bytearray()
    passes = ADAM7 if interlace else [(0, 0, 1, 1)]
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for row in sub:
            x = np.frombuffer(_pack_row(row, depth), np.uint8)
            if prev is None:
                prev = np.zeros_like(x)
            f = int(rng.choice(filters))
            raw.append(f)
            raw += _filter_row(x, prev, f, bpp).tobytes()
            prev = x
    idat = zlib.compress(bytes(raw), 6)
    cut = max(1, len(idat) // idat_parts)
    out = SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct,
                                            0, 0, interlace))
    for name, payload in extra_before:
        out += chunk(name, payload)
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    for i in range(0, len(idat), cut):
        out += chunk(b"IDAT", idat[i:i + cut])
    for name, payload in extra_after:
        out += chunk(name, payload)
    return out + chunk(b"IEND", b"")


def _same(got, want):
    assert (got.width, got.height, got.bit_depth, got.color_type,
            got.interlace) == (want.width, want.height, want.bit_depth,
                               want.color_type, want.interlace)
    assert got.pixels.dtype == want.pixels.dtype
    np.testing.assert_array_equal(got.pixels, want.pixels)
    for a, b in ((got.palette, want.palette), (got.trns, want.trns)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert got.metadata.keys() == want.metadata.keys()
    for k in got.metadata:
        if isinstance(got.metadata[k], np.ndarray):
            np.testing.assert_array_equal(got.metadata[k], want.metadata[k])
        else:
            assert got.metadata[k] == want.metadata[k], k
    assert got.warnings == want.warnings
    np.testing.assert_array_equal(got.to_rgba(), want.to_rgba())


CASES = [(ct, d, il) for ct, depths in ((0, (1, 2, 4, 8, 16)),
                                        (2, (8, 16)), (3, (1, 2, 4, 8)),
                                        (4, (8, 16)), (6, (8, 16)))
         for d in depths for il in (0, 1)]


@pytest.mark.parametrize("ct,depth,interlace", CASES)
def test_png_decode_matches_jax(ct, depth, interlace):
    rng = np.random.default_rng(100 * ct + depth + interlace)
    h, w = 13 + ct, 21 + depth
    c = CHANNELS[ct]
    top = (1 << depth) - 1
    px = rng.integers(0, top + 1, (h, w, c)).astype(
        np.uint16 if depth == 16 else np.uint8)
    palette = trns = None
    if ct == 3:
        palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
        trns = rng.integers(0, 256, max(1, (1 << depth) // 2),
                            dtype=np.uint8).tobytes()
    elif ct == 0:
        trns = struct.pack(">H", int(px[0, 0, 0]))
    elif ct == 2:
        trns = struct.pack(">HHH", *map(int, px[1, 2]))
    data = build_png(px, ct, depth, interlace, palette=palette, trns=trns,
                     seed=ct + depth)
    got = tpng.png_decode(data)
    _same(got, jpng.png_decode(data))
    np.testing.assert_array_equal(got.pixels, px)


def test_ancillary_chunks_match_jax():
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    itxt = b"Title\x00\x01\x00en\x00Titel\x00" + zlib.compress(
        "zusammen gepackt".encode())
    before = [(b"gAMA", struct.pack(">I", 45455)),
              (b"cHRM", struct.pack(">8I", *range(31270, 31278))),
              (b"sBIT", bytes([5, 6, 5])),
              (b"iCCP", b"icc\x00\x00" + zlib.compress(b"profile" * 20))]
    after = [(b"tEXt", b"Comment\x00plain text"),
             (b"zTXt", b"Author\x00\x00" + zlib.compress(b"packed " * 30)),
             (b"iTXt", itxt),
             (b"iTXt", b"Plain\x00\x00\x00\x00\x00uncompressed"),
             (b"pHYs", struct.pack(">IIB", 2835, 2835, 1)),
             (b"tIME", struct.pack(">HBBBBB", 2024, 5, 6, 7, 8, 9)),
             (b"sPLT", b"pal\x00\x08" + bytes(range(12))),
             (b"prIv", b"an unknown ancillary chunk")]
    data = build_png(px, 2, 8, extra_before=before, extra_after=after,
                     trns=None, seed=3)
    got = tpng.png_decode(data)
    _same(got, jpng.png_decode(data))
    assert got.metadata["text"]["Author"] == "packed " * 30
    assert got.metadata["itext"]["Title"]["text"] == "zusammen gepackt"
    assert any("prIv" in w for w in got.warnings)


def test_palette_histogram_and_background_match_jax():
    rng = np.random.default_rng(6)
    px = rng.integers(0, 16, (7, 10, 1), dtype=np.uint8)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    hist = struct.pack(">16H", *range(16))
    data = build_png(px, 3, 4, palette=palette, trns=bytes(range(0, 160, 20)),
                     extra_after=[(b"bKGD", b"\x03")])
    # hIST and bKGD go between PLTE and IDAT
    i = data.index(b"IDAT") - 4
    data = data[:i] + chunk(b"hIST", hist) + chunk(b"bKGD", b"\x02") + \
        data[i:]
    got = tpng.png_decode(data)
    _same(got, jpng.png_decode(data))
    assert got.metadata["background"] == 2


@pytest.mark.parametrize("case,code", [
    ("signature", "E_SIG"), ("critical_crc", "E_CRC"),
    ("missing_idat", "E_IDAT"), ("unknown_critical", "E_CHNAME"),
    ("truncated", "E_EOF"), ("truncated_chunk", "E_EOF"),
    ("bad_depth", "E_DEPTH"), ("idat_short", "E_IDAT"),
    ("duplicate_ihdr", "E_MULT"), ("plte_in_gray", "E_PLTE"),
    ("bad_filter", "E_FILTER"),
])
def test_png_errors_match_jax(case, code):
    rng = np.random.default_rng(9)
    px = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    data = build_png(px, 2, 8, filters=(0,))
    ihdr_end = 8 + 25
    if case == "signature":
        data = b"\x88" + data[1:]
    elif case == "critical_crc":
        data = data[:ihdr_end - 1] + bytes([data[ihdr_end - 1] ^ 1]) + \
            data[ihdr_end:]
    elif case == "missing_idat":
        data = data[:ihdr_end] + chunk(b"IEND", b"")
    elif case == "unknown_critical":
        data = data[:ihdr_end] + chunk(b"ABCD", b"x") + data[ihdr_end:]
    elif case == "truncated":
        data = data[:-12]
    elif case == "truncated_chunk":
        data = data[:-20]
    elif case == "bad_depth":
        data = data[:8] + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 5, 6, 4, 2, 0, 0, 0)) + data[ihdr_end:]
    elif case == "idat_short":
        data = data[:ihdr_end] + chunk(
            b"IDAT", zlib.compress(b"\x00" * 10)) + chunk(b"IEND", b"")
    elif case == "duplicate_ihdr":
        data = data[:ihdr_end] + data[8:ihdr_end] + data[ihdr_end:]
    elif case == "plte_in_gray":
        g = build_png(px[..., :1], 0, 8, filters=(0,))
        data = g[:ihdr_end] + chunk(b"PLTE", bytes(6)) + g[ihdr_end:]
    else:
        raw = b"".join(b"\x07" + bytes(15) for _ in range(6))
        data = data[:ihdr_end] + chunk(b"IDAT", zlib.compress(raw)) + \
            chunk(b"IEND", b"")
    with pytest.raises(JaxPngError) as j:
        jpng.png_decode(data)
    with pytest.raises(PngError) as e:
        tpng.png_decode(data)
    assert e.value.name == j.value.name == code
    assert e.value.code == j.value.code


def test_ancillary_crc_error_warns_like_jax():
    rng = np.random.default_rng(10)
    px = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
    data = build_png(px, 2, 8, extra_after=[(b"tEXt", b"Key\x00value")])
    i = data.index(b"tEXt")
    n = struct.unpack(">I", data[i - 4:i])[0]
    crc_at = i + 4 + n
    data = data[:crc_at] + bytes([data[crc_at] ^ 1]) + data[crc_at + 1:]
    got = tpng.png_decode(data)
    _same(got, jpng.png_decode(data))
    assert got.warnings and "text" not in got.metadata
    with pytest.raises(PngError) as e:
        tpng.png_decode(data, tolerant=False)
    assert e.value.name == "E_CRC"


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_defilter_matches_jax(bpp):
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (17, 5 * bpp), dtype=np.uint8)
    filters = rng.integers(0, 5, 17).astype(np.uint8)
    want = jpng.defilter(rows, filters, bpp, prefer_native=False)
    np.testing.assert_array_equal(
        tpng.defilter(rows, filters, bpp, prefer_native=False), want)
    assert tnb.available()
    np.testing.assert_array_equal(tpng.defilter(rows, filters, bpp), want)
    bad = filters.copy()
    bad[3] = 9
    for native in (True, False):
        with pytest.raises(PngError) as e:
            tpng.defilter(rows, bad, bpp, prefer_native=native)
        assert e.value.name == "E_FILTER"
