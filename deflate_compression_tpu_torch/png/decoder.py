"""PNG decoder, PNG 1.2 (counterpart of deflate_compression_tpu/png/decoder.py,
copied with its names, outputs and error codes), on the port's own host
inflater and CRC-32.

  * the 8-byte signature; chunks framed as (length, name, data, CRC), each
    CRC-32 checked (core/checksum.py);
  * the chunk order and multiplicity rules, and all 18 chunk types: IHDR
    PLTE IDAT IEND cHRM gAMA iCCP sBIT sRGB bKGD hIST tRNS pHYs sPLT tIME
    iTXt tEXt zTXt (iCCP, zTXt and iTXt inflate their payloads);
  * graded failure: an error in an ancillary (lowercase first letter)
    chunk warns and skips, a critical chunk aborts;
  * IDAT inflated by decode/inflate.zlib_decompress, which also holds every
    distance to the window the zlib header declares;
  * scanline defiltering None/Sub/Up/Average/Paeth (the native C++ pass
    where it builds, else the numpy loop below, the oracle);
  * Adam7 interlacing and 1/2/4/8/16-bit samples (16-bit big-endian).
"""
from __future__ import annotations

import dataclasses
import logging
import struct

import numpy as np

from ..core import checksum
from ..decode.inflate import zlib_decompress
from ..utils.errors import PngError

log = logging.getLogger("deflate_compression_tpu_torch.png")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Adam7 pass layout: (x0, y0, dx, dy) per pass (reference `pass` generator
# src/png/png_decoder.c:728-801)
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]

# channels per color type (reference IHDR matrix :153-188)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_VALID_DEPTHS = {0: {1, 2, 4, 8, 16}, 2: {8, 16}, 3: {1, 2, 4, 8},
                 4: {8, 16}, 6: {8, 16}}

# chunk order classes: 0 = IHDR, 1 = before-PLTE, 2 = PLTE zone,
# 3 = between PLTE and IDAT, 4 = IDAT, 5 = IEND
_KNOWN_CHUNKS = {
    "IHDR", "PLTE", "IDAT", "IEND", "cHRM", "gAMA", "iCCP", "sBIT", "sRGB",
    "bKGD", "hIST", "tRNS", "pHYs", "sPLT", "tIME", "iTXt", "tEXt", "zTXt",
}
_BEFORE_PLTE = {"cHRM", "gAMA", "iCCP", "sBIT", "sRGB"}
_AFTER_PLTE_BEFORE_IDAT = {"bKGD", "hIST", "tRNS"}
_ONCE_ONLY = {"IHDR", "PLTE", "IEND", "cHRM", "gAMA", "iCCP", "sBIT", "sRGB",
              "bKGD", "hIST", "tRNS", "pHYs", "tIME"}


@dataclasses.dataclass
class PngImage:
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    pixels: np.ndarray          # (H, W, channels), u8 or u16
    palette: np.ndarray | None = None        # (N, 3) u8
    trns: np.ndarray | None = None
    metadata: dict = dataclasses.field(default_factory=dict)
    warnings: list = dataclasses.field(default_factory=list)

    @property
    def channels(self) -> int:
        return _CHANNELS[self.color_type]

    def to_rgba(self) -> np.ndarray:
        """Expand to (H, W, 4) u8/u16 applying palette and tRNS."""
        px = self.pixels
        maxv = (1 << self.bit_depth) - 1 if self.color_type != 3 else 255
        dt = px.dtype
        H, W = self.height, self.width
        if self.color_type == 3:
            if self.palette is None:
                raise PngError("E_PLTE", "palette image without PLTE")
            idx = px[..., 0]
            rgb = self.palette[idx]
            alpha = np.full((H, W, 1), 255, np.uint8)
            if self.trns is not None:
                a = np.full(len(self.palette), 255, np.uint8)
                a[:len(self.trns)] = self.trns
                alpha = a[idx][..., None]
            return np.concatenate([rgb, alpha], axis=-1)
        if self.color_type == 0:
            g = px[..., 0]
            if self.bit_depth < 8:          # scale sub-byte gray to 8-bit
                g = (g.astype(np.uint16) * 255 // maxv).astype(np.uint8)
            out = np.stack([g, g, g,
                            np.full_like(g, maxv if self.bit_depth >= 8
                                         else 255)], axis=-1)
        elif self.color_type == 4:
            g, a = px[..., 0], px[..., 1]
            out = np.stack([g, g, g, a], axis=-1)
        elif self.color_type == 2:
            out = np.concatenate(
                [px, np.full((H, W, 1), maxv, dt)], axis=-1)
        else:  # 6
            out = px
        if self.trns is not None and self.color_type in (0, 2):
            key = self.trns
            if self.color_type == 0:
                transparent = px[..., 0] == key[0]
            else:
                transparent = np.all(px == key[None, None, :], axis=-1)
            out = out.copy()
            out[transparent, 3] = 0
        return out


def _paeth(a, b, c):
    """Paeth predictor (reference :803-817 — whose committed version assigns
    pa three times; this is the correct spec behavior)."""
    a = a.astype(np.int16)
    b = b.astype(np.int16)
    c = c.astype(np.int16)
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def defilter(rows: np.ndarray, filters: np.ndarray, bpp: int,
             prefer_native: bool = True) -> np.ndarray:
    """Undo scanline filters. rows: (H, rowbytes) u8 filtered data; filters:
    (H,) filter type per row. Returns reconstructed rows (reference defilter
    src/png/png_decoder.c:819-857).

    The Average/Paeth left-neighbor recurrence is byte-serial along x
    (the reference is byte-serial too); the native C++ runtime
    (dct_png_defilter) is the fast path for large photos — the Python loop
    below is the oracle, cross-checked in tests."""
    if prefer_native and rows.size:
        from .. import native_bridge
        if native_bridge.available():
            return native_bridge.png_defilter_native(rows.copy(), filters,
                                                     bpp)
    H, rb = rows.shape
    out = np.zeros_like(rows)
    prev = np.zeros(rb, np.uint8)
    for y in range(H):
        f = int(filters[y])
        row = rows[y]
        if f == 0:
            rec = row.copy()
        elif f == 1:  # Sub: per-lane modular prefix sum
            rec = row.copy()
            lanes = rec[:(rb // bpp) * bpp].reshape(-1, bpp)
            np.add.accumulate(lanes, axis=0, dtype=np.uint8, out=lanes)
            # tail bytes (rb not multiple of bpp cannot happen in PNG)
        elif f == 2:  # Up
            rec = row + prev
        elif f == 3:  # Average
            rec = np.zeros(rb, np.uint8)
            for x0 in range(0, rb, bpp):
                left = rec[x0 - bpp:x0] if x0 >= bpp else np.zeros(
                    min(bpp, rb - x0), np.uint8)
                up = prev[x0:x0 + bpp]
                rec[x0:x0 + bpp] = row[x0:x0 + bpp] + (
                    (left.astype(np.uint16) + up.astype(np.uint16)) // 2
                ).astype(np.uint8)
        elif f == 4:  # Paeth
            rec = np.zeros(rb, np.uint8)
            zeros = np.zeros(bpp, np.uint8)
            for x0 in range(0, rb, bpp):
                left = rec[x0 - bpp:x0] if x0 >= bpp else zeros[:rb - x0]
                up = prev[x0:x0 + bpp]
                upleft = prev[x0 - bpp:x0] if x0 >= bpp else zeros[:rb - x0]
                rec[x0:x0 + bpp] = row[x0:x0 + bpp] + _paeth(left, up, upleft)
        else:
            raise PngError("E_FILTER", f"unknown filter {f} on row {y}")
        out[y] = rec
        prev = rec
    return out


def _unpack_row(row: np.ndarray, width: int, channels: int,
                bit_depth: int) -> np.ndarray:
    """Bit-packed bytes -> (width, channels) samples (reference fill_img
    :869-923; sub-byte samples are MSB-first :906-913, 16-bit is big-endian
    :899-905)."""
    if bit_depth == 8:
        return row[:width * channels].reshape(width, channels)
    if bit_depth == 16:
        s = row[:width * channels * 2].reshape(width, channels, 2)
        return (s[..., 0].astype(np.uint16) << 8) | s[..., 1]
    # sub-byte: MSB-first within each byte
    n = width * channels
    bits = np.unpackbits(row)
    spb = 8 // bit_depth
    samples = bits[:len(row) * 8].reshape(-1, bit_depth)
    vals = np.zeros(samples.shape[0], np.uint8)
    for b in range(bit_depth):
        vals = (vals << 1) | samples[:, b]
    return vals[:n].reshape(width, channels)


class PngDecoder:
    """Stateful decoder (reference struct png_decoder
    src/png/include/png_decoder.h:105-204)."""

    def __init__(self, verify_crc: bool = True, tolerant: bool = True):
        self.verify_crc = verify_crc
        self.tolerant = tolerant
        self.seen: dict[str, int] = {}
        self.meta: dict = {}
        self.warnings: list[str] = []
        self.idat = bytearray()
        self.idat_done = False
        self.palette: np.ndarray | None = None
        self.trns: np.ndarray | None = None
        self.ihdr = None

    # ---------------------------------------------------------------- rules
    def _order_ok(self, name: str) -> bool:
        """Reference ch_order_ok :640-650."""
        if name == "IHDR":
            return not self.seen
        if not self.seen.get("IHDR"):
            return False
        if name in _BEFORE_PLTE:
            return not self.seen.get("PLTE") and not self.idat
        if name in _AFTER_PLTE_BEFORE_IDAT:
            return not self.idat
        if name == "PLTE":
            return not self.idat
        if name == "hIST":
            return bool(self.seen.get("PLTE")) and not self.idat
        if name == "IDAT":
            return not self.idat_done
        return True

    def _mult_ok(self, name: str) -> bool:
        """Reference ch_mult_ok :635-638."""
        if name in _ONCE_ONLY and self.seen.get(name):
            return False
        if name == "sPLT":
            return True
        return True

    def _chunk_failed(self, name: str, err: Exception):
        """Graded policy (reference ch_failure :117-132): ancillary chunks
        (lowercase first letter) degrade to a warning; critical chunks
        abort."""
        critical = name[:1].isupper()
        if critical or not self.tolerant:
            raise err
        msg = f"skipping ancillary chunk {name}: {err}"
        log.warning(msg)
        self.warnings.append(msg)

    # -------------------------------------------------------------- handlers
    def _ch_IHDR(self, d: bytes):
        if len(d) != 13:
            raise PngError("E_IHDR", f"IHDR length {len(d)} != 13")
        w, h, depth, ct, comp, filt, inter = struct.unpack(">IIBBBBB", d)
        if w == 0 or h == 0 or w > (1 << 31) - 1 or h > (1 << 31) - 1:
            raise PngError("E_IHDR", f"bad dimensions {w}x{h}")
        if ct not in _CHANNELS:
            raise PngError("E_IHDR", f"bad color type {ct}")
        if depth not in _VALID_DEPTHS[ct]:
            raise PngError("E_DEPTH",
                           f"depth {depth} invalid for color type {ct}")
        if comp != 0 or filt != 0:
            raise PngError("E_IHDR", "unknown compression/filter method")
        if inter not in (0, 1):
            raise PngError("E_INTERLACE", f"bad interlace {inter}")
        self.ihdr = (w, h, depth, ct, inter)

    def _ch_PLTE(self, d: bytes):
        if len(d) % 3 or not 3 <= len(d) <= 768:
            raise PngError("E_PLTE", f"bad PLTE length {len(d)}")
        _, _, depth, ct, _ = self.ihdr
        if ct in (0, 4):
            raise PngError("E_PLTE", "PLTE forbidden for grayscale")
        pal = np.frombuffer(d, np.uint8).reshape(-1, 3)
        if ct == 3 and len(pal) > (1 << depth):
            raise PngError("E_PLTE", "palette larger than depth allows")
        self.palette = pal

    def _ch_IDAT(self, d: bytes):
        self.idat += d

    def _ch_IEND(self, d: bytes):
        if d:
            raise PngError("E_CHLEN", "IEND must be empty")

    def _ch_tRNS(self, d: bytes):
        _, _, _, ct, _ = self.ihdr
        if ct == 3:
            if self.palette is None or len(d) > len(self.palette):
                raise PngError("E_PLTE", "tRNS without/exceeding palette")
            self.trns = np.frombuffer(d, np.uint8)
        elif ct == 0:
            self.trns = np.array(struct.unpack(">H", d))
        elif ct == 2:
            self.trns = np.array(struct.unpack(">HHH", d))
        else:
            raise PngError("E_IHDR", "tRNS forbidden with alpha channel")

    def _ch_gAMA(self, d: bytes):
        self.meta["gamma"] = struct.unpack(">I", d)[0] / 100000.0

    def _ch_cHRM(self, d: bytes):
        vals = struct.unpack(">8I", d)
        keys = ["wx", "wy", "rx", "ry", "gx", "gy", "bx", "by"]
        self.meta["chromaticity"] = {k: v / 100000.0 for k, v in zip(keys, vals)}

    def _ch_sRGB(self, d: bytes):
        intent = d[0]
        if intent > 3:
            raise PngError("E_IHDR", f"bad sRGB intent {intent}")
        self.meta["srgb_intent"] = intent

    def _ch_sBIT(self, d: bytes):
        self.meta["significant_bits"] = tuple(d)

    def _ch_bKGD(self, d: bytes):
        _, _, _, ct, _ = self.ihdr
        if ct == 3:
            self.meta["background"] = d[0]
        elif ct in (0, 4):
            self.meta["background"] = struct.unpack(">H", d)[0]
        else:
            self.meta["background"] = struct.unpack(">HHH", d)

    def _ch_hIST(self, d: bytes):
        if self.palette is None or len(d) != 2 * len(self.palette):
            raise PngError("E_PLTE", "hIST size mismatch")
        self.meta["histogram"] = np.frombuffer(d, ">u2").copy()

    def _ch_pHYs(self, d: bytes):
        x, y, unit = struct.unpack(">IIB", d)
        self.meta["phys"] = (x, y, unit)

    def _ch_tIME(self, d: bytes):
        y, mo, da, h, mi, s = struct.unpack(">HBBBBB", d)
        self.meta["time"] = (y, mo, da, h, mi, s)

    def _ch_tEXt(self, d: bytes):
        k, _, v = d.partition(b"\x00")
        self._check_keyword(k)
        self.meta.setdefault("text", {})[k.decode("latin-1")] = \
            v.decode("latin-1")

    def _ch_zTXt(self, d: bytes):
        """Compressed text — recursively inflates (reference :614)."""
        k, _, rest = d.partition(b"\x00")
        self._check_keyword(k)
        if not rest or rest[0] != 0:
            raise PngError("E_TEXT", "bad zTXt compression method")
        v = zlib_decompress(rest[1:])
        self.meta.setdefault("text", {})[k.decode("latin-1")] = \
            v.decode("latin-1")

    def _ch_iTXt(self, d: bytes):
        """International text, optionally compressed (reference :533)."""
        k, _, rest = d.partition(b"\x00")
        self._check_keyword(k)
        if len(rest) < 2:
            raise PngError("E_TEXT", "truncated iTXt")
        comp_flag, comp_method = rest[0], rest[1]
        lang, _, rest2 = rest[2:].partition(b"\x00")
        tkey, _, text = rest2.partition(b"\x00")
        if comp_flag:
            if comp_method != 0:
                raise PngError("E_TEXT", "bad iTXt compression method")
            text = zlib_decompress(text)
        self.meta.setdefault("itext", {})[k.decode("latin-1")] = {
            "lang": lang.decode("ascii", "replace"),
            "translated": tkey.decode("utf-8", "replace"),
            "text": text.decode("utf-8", "replace"),
        }

    def _ch_iCCP(self, d: bytes):
        """Embedded ICC profile — recursively inflates (reference :249)."""
        name, _, rest = d.partition(b"\x00")
        self._check_keyword(name)
        if "srgb_intent" in self.meta:
            raise PngError("E_ORDER", "iCCP with sRGB present")
        if not rest or rest[0] != 0:
            raise PngError("E_TEXT", "bad iCCP compression method")
        self.meta["icc_profile"] = (name.decode("latin-1"),
                                    zlib_decompress(rest[1:]))

    def _ch_sPLT(self, d: bytes):
        name, _, rest = d.partition(b"\x00")
        self._check_keyword(name)
        if not rest:
            raise PngError("E_TEXT", "truncated sPLT")
        depth = rest[0]
        if depth not in (8, 16):
            raise PngError("E_DEPTH", f"bad sPLT depth {depth}")
        entry = 6 if depth == 8 else 10
        if (len(rest) - 1) % entry:
            raise PngError("E_CHLEN", "bad sPLT payload size")
        self.meta.setdefault("suggested_palettes", {})[
            name.decode("latin-1")] = bytes(rest[1:])

    def _check_keyword(self, k: bytes):
        """Reference check_text_restrictions :134-151."""
        if not 1 <= len(k) <= 79:
            raise PngError("E_TEXT", f"keyword length {len(k)}")
        if k[:1] == b" " or k[-1:] == b" " or b"  " in k:
            raise PngError("E_TEXT", "bad keyword spacing")
        if any(c < 32 and c != 0 or 127 <= c < 161 for c in k):
            raise PngError("E_TEXT", "bad keyword character")

    # ------------------------------------------------------------- pipeline
    def decode(self, data: bytes) -> PngImage:
        if data[:8] != PNG_SIGNATURE:
            raise PngError("E_SIG", "bad PNG signature")
        pos = 8
        handlers = {n: getattr(self, f"_ch_{n}") for n in _KNOWN_CHUNKS}
        while True:
            if pos + 8 > len(data):
                raise PngError("E_EOF", "truncated before IEND")
            (length,) = struct.unpack(">I", data[pos:pos + 4])
            name_b = data[pos + 4:pos + 8]
            if length > (1 << 31) - 1:
                raise PngError("E_CHLEN", "chunk length overflow")
            if pos + 12 + length > len(data):
                raise PngError("E_EOF", f"truncated chunk {name_b!r}")
            payload = data[pos + 8:pos + 8 + length]
            (crc,) = struct.unpack(">I",
                                   data[pos + 8 + length:pos + 12 + length])
            pos += 12 + length
            name = name_b.decode("latin-1")

            try:
                if not all(65 <= c <= 90 or 97 <= c <= 122 for c in name_b):
                    raise PngError("E_CHNAME", f"bad chunk name {name_b!r}")
                if self.verify_crc:
                    got = checksum.crc32_np(name_b + payload)
                    if got != crc:
                        raise PngError("E_CRC",
                                       f"{name}: crc {got:#x} != {crc:#x}")
                if name in _KNOWN_CHUNKS:
                    if not self._mult_ok(name):
                        raise PngError("E_MULT", f"duplicate {name}")
                    if not self._order_ok(name):
                        raise PngError("E_ORDER", f"{name} out of order")
                    if name != "IDAT" and self.idat and not self.idat_done:
                        self.idat_done = True
                    handlers[name](payload)
                else:
                    # unknown critical chunk is fatal; ancillary ignored
                    if name_b[0] & 0x20 == 0:
                        raise PngError("E_CHNAME",
                                       f"unknown critical chunk {name}")
                    self.warnings.append(f"ignoring unknown chunk {name}")
            except PngError as e:
                self._chunk_failed(name, e)
            self.seen[name] = self.seen.get(name, 0) + 1
            if name == "IEND":
                break

        if not self.seen.get("IHDR"):
            raise PngError("E_IHDR", "missing IHDR")
        if not self.idat:
            raise PngError("E_IDAT", "missing IDAT")
        w, h, depth, ct, inter = self.ihdr
        if ct == 3 and self.palette is None:
            raise PngError("E_PLTE", "palette image without PLTE")

        raw = zlib_decompress(bytes(self.idat))
        channels = _CHANNELS[ct]
        bpp = max(1, channels * depth // 8)

        dt = np.uint16 if depth == 16 else np.uint8
        pixels = np.zeros((h, w, channels), dt)

        def rowbytes(width):
            return (width * channels * depth + 7) // 8

        passes = ADAM7 if inter == 1 else [(0, 0, 1, 1)]
        off = 0
        for (x0, y0, dx, dy) in passes:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            rb = rowbytes(pw)
            need = ph * (rb + 1)
            if off + need > len(raw):
                raise PngError("E_IDAT", "IDAT too short for image")
            block = np.frombuffer(raw[off:off + need], np.uint8)
            off += need
            block = block.reshape(ph, rb + 1)
            filters = block[:, 0]
            rows = defilter(np.ascontiguousarray(block[:, 1:]), filters, bpp)
            for ry in range(ph):
                samp = _unpack_row(rows[ry], pw, channels, depth)
                pixels[y0 + ry * dy, x0::dx][:pw] = samp
        if off != len(raw):
            self.warnings.append(
                f"{len(raw) - off} trailing bytes in IDAT stream")

        return PngImage(width=w, height=h, bit_depth=depth, color_type=ct,
                        interlace=inter, pixels=pixels, palette=self.palette,
                        trns=self.trns, metadata=self.meta,
                        warnings=self.warnings)


def png_decode(src, verify_crc: bool = True, tolerant: bool = True) -> PngImage:
    """Decode a PNG from bytes or a path (reference entry png_decode
    src/png/png_decoder.c:953-988)."""
    if isinstance(src, str):
        with open(src, "rb") as f:
            src = f.read()
    return PngDecoder(verify_crc=verify_crc, tolerant=tolerant).decode(src)
