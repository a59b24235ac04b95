"""gzip_indexed_decode: `decompress_gzip_indexed(member, index, shard_out)`
of one object's gzip member, host bytes out, its CRC-32 and ISIZE checked
on the card. The index is built from the member's body by `build_index`
(the native pass) in set-up, as a reader that keeps a saved index does
once, and every member is decoded once to warm up. After the window the
bytes of the first pass (every object once, from the seed-drawn first
object) are compared with the objects, every call's verdict (raised or
not) with the reference's on the member, and three altered members must
be refused: a stored byte flipped, the footer's CRC-32 and its ISIZE."""
from __future__ import annotations

from deflate_compression_tpu_torch.decode import index as IDX
from deflate_compression_tpu_torch.format.containers import gzip_parse_header

from .. import inputs, members, reference_gzip
from . import content_seed, tampered

if not hasattr(IDX, "decompress_gzip_indexed"):
    # at once, before the members are written
    raise ImportError("this tree's port has no decompress_gzip_indexed")


class Entry:
    def __init__(self, cfg, traffic, dev, seed, scale, cache_root):
        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        self.seed, self.scale, self.cache_root = seed, scale, cache_root
        self.results = []
        self.kept = {}

    def make_inputs(self):
        pass                  # the objects come with the cached members

    def make_streams(self):
        if not IDX.native_available():
            raise RuntimeError("build_index needs the native pass here: the "
                               "Python pass would take hours a run")
        self.content = content_seed(self.traffic, self.seed)
        self.members = members.members(self.cfg, self.traffic, self.content,
                                       self.scale, self.cache_root)
        self.heads = [gzip_parse_header(m) for m in self.members]
        self.indexes = [
            IDX.build_index(memoryview(m)[h:],
                            sub_size=self.cfg["index_sub_size"])
            for m, h in zip(self.members, self.heads)]

    def _decode(self, k, member=None):
        return IDX.decompress_gzip_indexed(
            self.members[k] if member is None else member, self.indexes[k],
            shard_out=self.cfg["decode_group_bytes"], device=self.dev)

    def warm_up(self, k):
        # every object once, so each member's groups, window crossings and
        # last group have run before the window
        for j in range(len(self.members)):
            self._decode((k + j) % len(self.members))

    def call(self, k):
        out = self._decode(k)
        if k not in self.kept:            # the first pass's bytes
            self.kept[k] = out
        self.results.append((k, len(out)))
        return len(out)

    def end_to_end(self, seconds):
        n = sum(o for _, o in self.results if isinstance(o, int))
        return {"decode_MBps": n / seconds / 1e6}

    def probes(self) -> list[tuple[int, bytes]]:
        """(object, altered member) that a verified decode must refuse: a
        stored payload byte flipped (drawn from the seed), then the same
        object's footer CRC-32 and ISIZE altered; none where no member
        has a stored byte."""
        bodies = [{"index": i, "body": m[h:]} for m, h, i in
                  zip(self.members, self.heads, self.indexes)]
        found = tampered(bodies, self.seed)
        if found is None:
            return []
        k, body = found
        m = self.members[k]
        return [(k, m[:self.heads[k]] + body)] + [
            (k, reference_gzip.footer_altered(m, f))
            for f in ("crc32", "isize")]

    def check(self):
        objs = inputs.make(self.content, self.scale, self.traffic["objects"])
        valid = [reference_gzip.member_valid(m, o)
                 for m, o in zip(self.members, objs)]
        tot = {"bytes_wrong": 0, "verdict_wrong": 0, "tamper_missed": 0}
        for k, out in self.results:
            tot["verdict_wrong"] += (not isinstance(out, int)) == valid[k]
        for k, out in self.kept.items():
            tot["bytes_wrong"] += reference_gzip.bytes_wrong(out, objs[k])
        probes = self.probes()
        tot["tamper_missed"] = 3 - len(probes)   # no probe: each missed
        for k, member in probes:
            try:
                self._decode(k, member)
                tot["tamper_missed"] += 1
            except IDX.DeflateError:
                pass
        return tot
