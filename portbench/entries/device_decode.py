"""device_decode: the verified flat decode of one object on the card.

Set-up uploads each object's stream, cut into its shards' words, and its
decode index rebased shard by shard (`decode_blocks_batch`'s arguments),
with the Adler-32 of each shard. A call is one `decode_blocks_batch` over
the object's shards, `adler32_torch` of each shard's bytes compared on
the card with the checksum index, and one read of the verdict; the bytes
stay on the card. After the window: every call's verdict, `ok` and
per-shard Adler-32 against the reference's, the bytes of the first pass
(every object once) against the objects, and one stream with a stored
byte flipped, which the verdict must refuse.
"""
from __future__ import annotations

import numpy as np
import torch

from deflate_compression_tpu_torch.core import checksum as CK
from deflate_compression_tpu_torch.decode import device_inflate as DI

from .. import inputs, reference, streams
from . import content_seed, tampered


def flat_args(body: bytes, idx, S: int, dev) -> dict:
    """decode_blocks_batch arguments of a stream from its stream-level
    decode index: each shard's blocks and sub-entries rebased to the
    shard's first byte (every shard starts byte-aligned with a block),
    dead block slots btype -1 and dead lanes sub_blk -1."""
    n = idx.out_len
    nsh = max(1, -(-n // S))
    first = [int(np.searchsorted(idx.out_start, s * S)) for s in range(nsh)]
    first.append(idx.n_blocks)
    byte0 = [int(idx.bit_base[b]) // 8 for b in first[:-1]] + [len(body)]
    sk_all = (idx.sub_blk if idx.n_subs else np.zeros(0)).astype(np.int64)
    sfirst = [int(np.searchsorted(sk_all, b)) for b in first]
    nb = max(first[s + 1] - first[s] for s in range(nsh))
    nl = max(1, max(sfirst[s + 1] - sfirst[s] for s in range(nsh)))
    cw = max((byte0[s + 1] - byte0[s] + 3) // 4 for s in range(nsh)) + 1
    words = np.zeros((nsh, cw), np.int64)
    blk = np.zeros((3, nsh, nb), np.int64)
    blk[2] = -1
    sub = np.zeros((3, nsh, nl), np.int64)
    sub[0], sub[2] = -1, -1
    nblk = np.zeros(nsh, np.int64)
    for s in range(nsh):
        part = body[byte0[s]:byte0[s + 1]]
        part += bytes(-len(part) % 4)
        words[s, :len(part) // 4] = np.frombuffer(part, "<u4")
        b0, b1 = first[s], first[s + 1]
        nblk[s] = b1 - b0
        blk[0, s, :b1 - b0] = idx.bit_base[b0:b1] - 8 * byte0[s]
        blk[1, s, :b1 - b0] = idx.out_start[b0:b1] - s * S
        blk[2, s, :b1 - b0] = idx.btype[b0:b1]
        l0, l1 = sfirst[s], sfirst[s + 1]
        if l1 > l0:
            sub[0, s, :l1 - l0] = idx.sub_bit[l0:l1] - 8 * byte0[s]
            sub[1, s, :l1 - l0] = idx.sub_out[l0:l1] - s * S
            sub[2, s, :l1 - l0] = sk_all[l0:l1] - b0
    valid = [min(S, n - s * S) for s in range(nsh)]
    args = [torch.from_numpy(x).to(dev) for x in
            (words, blk[0], blk[1], blk[2], nblk, sub[0], sub[1], sub[2],
             np.array(valid, np.int64))]
    return {"args": args, "valid": valid}


class Entry:
    def __init__(self, cfg, traffic, dev, seed, scale, cache_root):
        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        self.seed, self.scale, self.cache_root = seed, scale, cache_root
        self.S = cfg["shard_size"]
        self.results = []
        self.kept = {}

    def make_inputs(self):
        pass                  # the objects come with the cached streams

    def _batch(self, st, body=None):
        body = st["body"] if body is None else body
        b = flat_args(body, st["index"], self.S, self.dev)
        b["want"] = torch.tensor(st["shard_adler"], dtype=torch.int64,
                                 device=self.dev)
        b["body"] = body                  # the stream, for the control
        return b

    def make_streams(self):
        self.content = content_seed(self.traffic, self.seed)
        self.streams = streams.streams(self.cfg, self.traffic, self.content,
                                       self.dev, self.scale, self.cache_root)
        self.batches = [self._batch(st) for st in self.streams]

    def _decode(self, b):
        r = DI.decode_blocks_batch(*b["args"], self.S)
        ad = torch.stack([CK.adler32_torch(r["out"][s], v)
                          for s, v in enumerate(b["valid"])])
        good = bool(r["ok"] & (ad == b["want"]).all())
        return r, ad, good

    def warm_up(self, k):
        self._decode(self.batches[k])

    def call(self, k):
        r, ad, good = self._decode(self.batches[k])
        if k not in self.kept:            # the first pass's bytes
            self.kept[k] = r["out"]
        self.results.append((k, (good, r["ok"], ad)))
        return sum(self.batches[k]["valid"])

    def end_to_end(self, seconds):
        n = sum(sum(self.batches[k]["valid"]) for k, o in self.results
                if isinstance(o, tuple))
        return {"device_decode_MBps": n / seconds / 1e6}

    def check(self):
        objs = inputs.make(self.content, self.scale, self.traffic["objects"])
        want = [reference.shard_adlers(o, self.S) for o in objs]
        valid = [reference.stream_valid(st["body"], st["adler"], o)
                 for st, o in zip(self.streams, objs)]
        tot = {"bytes_wrong": 0, "adler_wrong": 0, "verdict_wrong": 0,
               "tamper_missed": 0}
        for k, res in self.results:
            if not isinstance(res, tuple):      # the answer never came
                tot["verdict_wrong"] += 1
                continue
            good, ok, ad = res
            tot["verdict_wrong"] += (good != valid[k]) + (
                bool(ok) != valid[k])
            tot["adler_wrong"] += sum(
                a != w for a, w in zip(ad.tolist(), want[k]))
        for k, out in self.kept.items():
            o = out.cpu().numpy()
            got = np.concatenate([o[s, :v] for s, v in
                                  enumerate(self.batches[k]["valid"])])
            tot["bytes_wrong"] += reference.bytes_wrong(got, objs[k])
        probe = tampered(self.streams, self.seed)
        if probe is None:
            tot["tamper_missed"] = 1          # no stream to probe with
        else:
            k, body = probe
            tot["tamper_missed"] = int(self._decode(
                self._batch(self.streams[k], body))[2])
        return tot
