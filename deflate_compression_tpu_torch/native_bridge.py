"""ctypes bridge to the repository's native C++ host runtime
(native/deflate_native.cpp): the index pass of `decode.index.build_index`,
the inflater of `decode.inflate` (raw and zlib), the PNG defilter of
`png.decoder` and the CRC-32 / Adler-32 loops, with the JAX package's
signatures and grow-and-retry loops.

The port builds its own copy of the library from that source, with the
system C++ compiler, at first use, into the git-ignored `build/` beside
this package (never into `native/`). The library's name carries a hash of
the source and flags; the compiler writes a temporary name that
`os.replace` publishes under an `fcntl` lock, so concurrent processes (test
workers, the JAX package's own build in `native/`) never see a partial
file. Where no compiler or source is found, `available()` is False and
each caller takes its Python path on the host.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .utils.errors import DeflateError

log = logging.getLogger("deflate_compression_tpu_torch.native")

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "deflate_native.cpp"
BUILD_DIR = _PKG / "build"
ABI_VERSION = 2
# no -march=native: a checkout may be built on one host and run on another
_FLAGS = ["-O3", "-fPIC", "-Wall", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None
_tried = False

_ERRNAMES = {
    -1: "E_TRUNC", -2: "E_BTYPE", -3: "E_STORED", -4: "E_TREE",
    -5: "E_BADCODE", -6: "E_SYM", -7: "E_DIST", -8: "E_SIZE",
    -9: "E_HDR", -10: "E_ADLER",
}


def lib_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(_FLAGS).encode()
                         ).hexdigest()[:12]
    return BUILD_DIR / f"libdeflate_native_{tag}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path.
    Raises where the source or a compiler is missing or the build fails."""
    path = lib_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler for the native index pass")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            try:
                subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, path)
            finally:
                tmp.unlink(missing_ok=True)
    return path


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            log.info("native runtime unavailable: %s", e)
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.dct_inflate2.restype = ctypes.c_int64
        lib.dct_inflate2.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, i64p, ctypes.c_int64]
        lib.dct_zlib_decompress.restype = ctypes.c_int64
        lib.dct_zlib_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int]
        lib.dct_png_defilter.restype = ctypes.c_int64
        lib.dct_png_defilter.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.dct_crc32.restype = ctypes.c_uint32
        lib.dct_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_uint32]
        lib.dct_adler32.restype = ctypes.c_uint32
        lib.dct_adler32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_uint32]
        lib.dct_build_index.restype = ctypes.c_int64
        lib.dct_build_index.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p, ctypes.c_void_p,
            ctypes.c_int64, i64p, i64p, ctypes.c_void_p,
            ctypes.c_int64, i64p, i64p, i64p]
        if lib.dct_abi_version() != ABI_VERSION:
            log.info("native library has ABI %d, want %d",
                     lib.dct_abi_version(), ABI_VERSION)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _grown(call, data: bytes, what: str) -> bytes:
    """call(out, cap) into a growing output buffer: retried 4x larger on
    E_SIZE up to 8 GiB; another negative code raises its DeflateError."""
    cap = max(4 * len(data), 1 << 16)
    while True:
        out = ctypes.create_string_buffer(cap)
        r = call(out, cap)
        if r >= 0:
            return out.raw[:r]
        if r == -8:  # E_SIZE: grow and retry
            cap *= 4
            if cap > (1 << 33):
                raise DeflateError("E_SIZE", "output exceeds 8 GiB cap")
            continue
        raise DeflateError(_ERRNAMES.get(int(r), "E_HDR"),
                           f"native {what} error {int(r)}")


def inflate_raw_native(data: bytes, bit_pos: int = 0,
                       max_dist: int = 32768):
    """Native inflate_raw; returns (bytes, end_bit_pos) like the Python
    one."""
    lib = get_lib()
    end = ctypes.c_int64(0)
    out = _grown(lambda buf, cap: lib.dct_inflate2(
        data, len(data), bit_pos, buf, cap, ctypes.byref(end), max_dist),
        data, "inflate")
    return out, int(end.value)


def zlib_decompress_native(data: bytes, verify: bool = True) -> bytes:
    lib = get_lib()
    return _grown(lambda buf, cap: lib.dct_zlib_decompress(
        data, len(data), buf, cap, 1 if verify else 0), data, "zlib")


def png_defilter_native(rows, filters, bpp: int):
    """In-place PNG scanline defilter over (H, rb) u8 rows. Returns the
    reconstructed array (same buffer)."""
    from .utils.errors import PngError
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    H, rb = rows.shape
    r = get_lib().dct_png_defilter(
        rows.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(filters, dtype=np.uint8).tobytes(),
        H, rb, bpp)
    if r != 0:
        raise PngError("E_FILTER", "unknown filter type")
    return rows


def crc32_native(data: bytes, crc: int = 0) -> int:
    return int(get_lib().dct_crc32(data, len(data), crc & 0xFFFFFFFF))


def adler32_native(data: bytes, adler: int = 1) -> int:
    return int(get_lib().dct_adler32(data, len(data), adler & 0xFFFFFFFF))


def build_index_native(data: bytes, bit_pos: int = 0, sub_size: int = 1024):
    """Native one-pass decode-index construction. Returns (blk_bits,
    blk_outs, blk_types, sub_bits, sub_outs, sub_blks, out_len) numpy
    arrays, or raises DeflateError on malformed streams."""
    lib = get_lib()
    i64p = ctypes.POINTER(ctypes.c_int64)
    blk_cap = 256
    sub_cap = max(4096, 2 * (4 * len(data) // max(sub_size, 1) + 2))
    while True:
        bb = np.zeros(blk_cap, np.int64)
        bo = np.zeros(blk_cap, np.int64)
        bt = np.zeros(blk_cap, np.uint8)
        sb = np.zeros(sub_cap, np.int64)
        so = np.zeros(sub_cap, np.int64)
        sk = np.zeros(sub_cap, np.int32)
        nb = ctypes.c_int64(0)
        ns = ctypes.c_int64(0)
        end = ctypes.c_int64(0)
        r = lib.dct_build_index(
            data, len(data), bit_pos, sub_size,
            bb.ctypes.data_as(i64p), bo.ctypes.data_as(i64p),
            bt.ctypes.data_as(ctypes.c_void_p), blk_cap,
            sb.ctypes.data_as(i64p), so.ctypes.data_as(i64p),
            sk.ctypes.data_as(ctypes.c_void_p), sub_cap,
            ctypes.byref(nb), ctypes.byref(ns), ctypes.byref(end))
        if r >= 0:
            n, m = int(nb.value), int(ns.value)
            return (bb[:n], bo[:n], bt[:n], sb[:m], so[:m], sk[:m], int(r))
        if r == -8:  # E_SIZE: grow both tables and retry
            blk_cap *= 8
            sub_cap *= 4
            if blk_cap > (1 << 28):
                raise DeflateError("E_SIZE", "index table cap exceeded")
            continue
        raise DeflateError(_ERRNAMES.get(int(r), "E_HDR"),
                           f"native index error {int(r)}")
