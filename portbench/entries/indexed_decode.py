"""indexed_decode: `decompress_indexed(stream, index, shard_out,
expected_adler)` of one object's cached stream, host bytes out. After the
window the bytes of the first pass (every object once, from the
seed-drawn first object) are compared with the objects, every call's
verdict (raised or not) with the reference's verdict on the stream, and
one stream of the pass, with a stored byte flipped, must be refused.
Later passes' bytes are not kept: a 30 s window decodes some 5 GB."""
from __future__ import annotations

from deflate_compression_tpu_torch.decode import index as IDX

from .. import inputs, reference, streams
from . import content_seed, tampered


class Entry:
    def __init__(self, cfg, traffic, dev, seed, scale, cache_root):
        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        self.seed, self.scale, self.cache_root = seed, scale, cache_root
        self.results = []
        self.kept = {}

    def make_inputs(self):
        pass                  # the objects come with the cached streams

    def make_streams(self):
        self.content = content_seed(self.traffic, self.seed)
        self.streams = streams.streams(self.cfg, self.traffic, self.content,
                                       self.dev, self.scale, self.cache_root)

    def _decode(self, st, body=None):
        return IDX.decompress_indexed(
            st["body"] if body is None else body, st["index"],
            shard_out=self.cfg["decode_group_bytes"],
            expected_adler=st["adler"], device=self.dev)

    def warm_up(self, k):
        self._decode(self.streams[k])

    def call(self, k):
        out = self._decode(self.streams[k])
        if k not in self.kept:            # the first pass's bytes
            self.kept[k] = out
        self.results.append((k, len(out)))
        return len(out)

    def end_to_end(self, seconds):
        n = sum(o for _, o in self.results if isinstance(o, int))
        return {"decode_MBps": n / seconds / 1e6}

    def check(self):
        objs = inputs.make(self.content, self.scale, self.traffic["objects"])
        valid = [reference.stream_valid(st["body"], st["adler"], o)
                 for st, o in zip(self.streams, objs)]
        tot = {"bytes_wrong": 0, "verdict_wrong": 0, "tamper_missed": 0}
        for k, out in self.results:
            tot["verdict_wrong"] += (not isinstance(out, int)) == valid[k]
        for k, out in self.kept.items():
            tot["bytes_wrong"] += reference.bytes_wrong(out, objs[k])
        probe = tampered(self.streams, self.seed)
        if probe is None:
            tot["tamper_missed"] = 1        # no stream to probe with
        else:
            k, body = probe
            try:
                self._decode(self.streams[k], body)
                tot["tamper_missed"] = 1
            except IDX.DeflateError:
                pass
        return tot
