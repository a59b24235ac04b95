"""Codec configuration: one frozen dataclass threaded through every entry
point. With the input and the shard plan it fixes the emitted bitstream.

The port's own copy of deflate_compression_tpu/utils/config.py: the same
fields, defaults, validation and `force_btype`, so a configuration means
the same stream in both packages.
"""
from __future__ import annotations

import dataclasses

BLOCK_SIZE = 32768


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    # shard = unit of device-parallel work; must be a multiple of 32768
    shard_size: int = 1 << 20
    # LZ77 search effort: nearest same-hash candidates scored per position
    num_candidates: int = 32
    # one-step lazy matching (zlib-style)
    lazy: bool = True
    # container: "raw" | "zlib" | "gzip"
    container: str = "zlib"
    # block type: "auto" (cost-based selection) | "stored" | "fixed" | "dynamic"
    block_type: str = "auto"
    # verify checksums on decode
    verify_checksums: bool = True
    # online encode verification: replay each shard's emitted tokens before
    # its bytes are committed to output
    self_check: bool = False

    def __post_init__(self):
        if self.shard_size % BLOCK_SIZE or self.shard_size <= 0:
            raise ValueError("shard_size must be a positive multiple of 32768")
        if self.container not in ("raw", "zlib", "gzip"):
            raise ValueError(f"unknown container {self.container!r}")
        if not 1 <= self.num_candidates <= 64:
            raise ValueError("num_candidates must be in [1, 64]")
        if self.block_type not in ("auto", "stored", "fixed", "dynamic"):
            raise ValueError(f"unknown block_type {self.block_type!r}")

    @property
    def force_btype(self):
        return {"auto": None, "stored": 0, "fixed": 1,
                "dynamic": 2}[self.block_type]


DEFAULT_CONFIG = CodecConfig()
