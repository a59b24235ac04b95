"""bulk_encode: `ZlibCodec(cfg, device="cuda").compress(obj)` on host
bytes, the blob back on the host. Every blob is judged after the window:
inflated piece by piece against its object under the configuration's
guarantees (lossless, independent blocks, the zlib container)."""
from __future__ import annotations

from deflate_compression_tpu_torch.models.codec import ZlibCodec

from .. import inputs, reference
from . import codec_config


class Entry:
    def __init__(self, cfg, traffic, dev, seed, scale, cache_root):
        self.cfg, self.traffic, self.seed, self.scale = \
            cfg, traffic, seed, scale
        self.codec = ZlibCodec(codec_config(cfg), device=dev)
        self.results = []

    def make_inputs(self):
        self.objs = inputs.make(self.seed, self.scale, self.traffic["objects"])

    def make_streams(self):
        pass

    def warm_up(self, k):
        self.codec.compress(self.objs[k])

    def call(self, k):
        self.results.append((k, self.codec.compress(self.objs[k])))
        return len(self.objs[k])

    def end_to_end(self, seconds):
        done = [(k, b) for k, b in self.results if isinstance(b, bytes)]
        n_in = sum(len(self.objs[k]) for k, _ in done)
        n_out = sum(len(b) for _, b in done)
        return {"encode_MBps": n_in / seconds / 1e6,
                "ratio": n_out / max(n_in, 1)}

    def check(self):
        tot = {"bytes_wrong": 0, "shards_not_independent": 0,
               "container_wrong": 0}
        for k, blob in self.results:
            if not isinstance(blob, bytes):       # the answer never came
                tot["bytes_wrong"] += len(self.objs[k])
                continue
            for name, v in reference.check_zlib(
                    blob, self.objs[k], self.cfg["shard_size"]).items():
                tot[name] += v
        return tot
