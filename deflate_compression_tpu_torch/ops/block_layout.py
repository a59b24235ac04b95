"""The shard encoder's block layout scan: CUDA kernel wrapper and its plain
version.

Counterpart of the NB-step loop of deflate_compression_tpu/format/
deflate.py (:520-534, a lax.scan), which the JAX package left to XLA: it
has no Pallas kernel. Each coding block starts where the last one ended; a
stored block pads its 3 header bits to the next byte edge before LEN.

The kernel (`csrc/block_layout.cu`: one CTA, thread 0 walks the blocks
staged in shared memory) is built at first use by `ops/cuda_build.py` and
called through ctypes on PyTorch's current stream. `block_layout` launches
it for CUDA tensors and raises if it cannot; it takes the plain version
`block_layout_ref` only for tensors that lie on the CPU.
`block_layout.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "block_layout.cu"


@functools.cache
def _bind():
    """The kernel's launch function, bound once, and the raw current-stream
    lookup."""
    vp = ctypes.c_void_p
    lib = cuda_build.load(SOURCE, {"block_layout_launch": [
        vp, vp, ctypes.c_int64, vp, vp, vp, ctypes.c_int, vp]})
    return lib.block_layout_launch, cuda_build.raw_stream()


def _check(rest: torch.Tensor, stored: torch.Tensor) -> None:
    if not isinstance(rest, torch.Tensor) or not isinstance(stored,
                                                            torch.Tensor):
        raise TypeError("rest and stored must be torch.Tensors")
    if rest.dtype != torch.int64 or stored.dtype != torch.bool:
        raise TypeError(f"want rest int64 and stored bool, got {rest.dtype} "
                        f"and {stored.dtype}")
    if rest.dim() != 1 or stored.shape != rest.shape:
        raise ValueError(f"want rest and stored of one shape (NB,), got "
                         f"{tuple(rest.shape)} and {tuple(stored.shape)}")
    if not 1 <= rest.shape[0] <= 2**31 - 1:
        raise ValueError("NB must be in [1, 2^31 - 1]")
    if stored.device != rest.device:
        raise ValueError(f"stored is on {stored.device}, rest on "
                         f"{rest.device}")
    if not (rest.is_contiguous() and stored.is_contiguous()):
        raise ValueError("rest and stored must be contiguous")


def block_layout_ref(rest: torch.Tensor, stored: torch.Tensor):
    """Plain PyTorch version of the kernel. Arguments and result as for
    `block_layout`."""
    p = torch.zeros((), dtype=torch.int64, device=rest.device)
    bases, pads = [], []
    for b in range(rest.shape[0]):
        pad = torch.where(stored[b], (8 - ((p + 3) % 8)) % 8, 0)
        bases.append(p)
        pads.append(pad)
        p = p + rest[b] + pad
    return torch.stack(bases), torch.stack(pads), p


def block_layout(rest: torch.Tensor, stored: torch.Tensor):
    """Lay out NB coding blocks one after another.

    rest: int64[NB], each block's bits without its stored pad (header,
    tokens, EOB, stored payload); stored: bool[NB], blocks emitted as
    stored. Returns (base int64[NB], pad int64[NB], p_end int64): the bit
    offset of each block, the pad that puts a stored block's LEN on a byte
    edge (0 for the others) and the end of the last block. A CUDA tensor
    goes through the CUDA kernel (or this raises); a CPU tensor through
    `block_layout_ref`."""
    _check(rest, stored)
    dev = rest.device
    if dev.type == "cpu":
        return block_layout_ref(rest, stored)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb = rest.shape[0]
    out = torch.empty(2 * nb + 1, dtype=torch.int64, device=dev)
    launch, stream = _bind()
    rc = launch(rest.data_ptr(), stored.data_ptr(), nb, out.data_ptr(),
                out[nb:].data_ptr(), out[2 * nb:].data_ptr(), dev.index,
                stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"block_layout launch failed: cudaError {rc}")
    block_layout.launches += 1
    return out[:nb], out[nb:2 * nb], out[2 * nb]


block_layout.launches = 0
