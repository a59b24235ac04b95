"""Logging and metrics (counterpart of
deflate_compression_tpu/utils/logging_util.py): one-call setup of the
port's logger hierarchy (deflate_compression_tpu_torch.*) and an
append-only metrics recorder whose cost trace is the reference's format B
(`bytes,compressed_bits`).
"""
from __future__ import annotations

import logging
import os
import sys
import time

LOGGER_NAME = "deflate_compression_tpu_torch"


def setup_logging(level: str | int | None = None, stream=None) -> None:
    """Configure the port's logger; the level also via the DCT_LOG
    environment variable."""
    if level is None:
        level = os.environ.get("DCT_LOG", "WARNING")
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)


class MetricsRecorder:
    """Append-only (t, key, value) metric log with the reference-format CSV
    export of the cost trace."""

    def __init__(self):
        self.records: list[tuple[float, str, float]] = []
        self._t0 = time.monotonic()

    def record(self, key: str, value: float) -> None:
        self.records.append((time.monotonic() - self._t0, key, float(value)))

    def cost_trace_csv(self) -> str:
        """Reference format B: cumulative (bytes, compressed_bits)."""
        lines = ["bytes,compressed_bits"]
        cb = cbits = 0
        for _, key, v in self.records:
            if key == "block_bytes":
                cb += int(v)
            elif key == "block_bits":
                cbits += int(v)
                lines.append(f"{cb},{cbits}")
        return "\n".join(lines) + "\n"

    def summary(self) -> dict:
        out: dict[str, list[float]] = {}
        for _, k, v in self.records:
            out.setdefault(k, []).append(v)
        return {k: {"count": len(v), "sum": sum(v), "last": v[-1]}
                for k, v in out.items()}
