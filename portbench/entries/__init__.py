"""The calls a cell's window makes, one module a kind of entry, named by
the traffic file's "entry". Each module has an `Entry` class:

    Entry(cfg, traffic, dev, seed, scale, cache_root)
    make_inputs()    set-up part (c): the objects from the seed
    make_streams()   set-up part (d): the decode cells' cached streams
    warm_up(k)       set-up part (e): one call on object k
    call(k)          one call of the window on object k; returns the
                     bytes it counts toward the rate
    end_to_end(s)    the end-to-end metrics over the window's s seconds
    check()          after the window: the numbers compared, by the plain
                     reference (`reference.py`)

`results` holds each call's (object, outcome); an outcome is an exception
where the call raised.
"""
from __future__ import annotations


def codec_config(cfg: dict):
    from deflate_compression_tpu_torch.utils.config import CodecConfig
    return CodecConfig(shard_size=cfg["shard_size"],
                       num_candidates=cfg["num_candidates"], lazy=cfg["lazy"],
                       container=cfg["container"],
                       block_type=cfg["block_type"])


def content_seed(traffic: dict, seed: int) -> int:
    """The content a decode cell's run decodes: one of the traffic's
    content seeds, drawn from the run's seed."""
    import numpy as np
    seeds = traffic["content_seeds"]
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 3])
    return int(seeds[int(rng.integers(len(seeds)))])


def tampered(streams: list[dict], seed: int):
    """(object, body) of the first stream of the pass that has a stored
    block, one payload byte of it, drawn from the seed, flipped: a stream
    that still decodes, to the wrong bytes, which only the Adler-32 can
    catch. None where no stream has a stored byte."""
    for k, st in enumerate(streams):
        at = _stored_byte(st["index"], st["body"], seed)
        if at >= 0:
            body = bytearray(st["body"])
            body[at] ^= 0xFF
            return k, bytes(body)
    return None


def _stored_byte(index, body: bytes, seed: int) -> int:
    """The offset in `body` of one payload byte of a stored block, drawn
    from the seed; -1 where the stream has no stored byte."""
    import numpy as np
    blocks = []
    for b in np.flatnonzero(index.btype == 0):
        at = (int(index.bit_base[b]) + 3 + 7) // 8
        n = int.from_bytes(body[at:at + 2], "little")
        if n:
            blocks.append((at + 4, n))
    if not blocks:
        return -1
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 7])
    at, n = blocks[int(rng.integers(len(blocks)))]
    return at + int(rng.integers(n))
