"""Prefix scans (counterpart of deflate_compression_tpu/core/scans.py).

The JAX module blocks its scans in two levels to cut XLA's log2(S) passes
on the TPU. PyTorch's own scans are single-pass on the card, so these are
plain `cummin` / `cummax` with the same semantics: the reverse run-end
cummin of the LZ77 stage's plain version (ops/lz_parse.py) and the
row-wise cummax of the encoder's sub-entry index (format/deflate.py).
"""
from __future__ import annotations

import torch


def cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x, dim=0).values


def cummax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise cummax of a 2-D tensor along dim 1."""
    return torch.cummax(x, dim=1).values
