"""Time two trees of the port in turns on one CUDA card.

    python3 kernel_turns.py TREE [TREE ...] [--out FILE] [--phases-only]
        [--block-stage-only]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with `git archive` into a git-ignored directory,
and `.`). The trees run one after another in the order given, each in a
process of its own that imports that tree's `deflate_compression_tpu_torch`
(so give them as parent, change, change, parent). Each process measures,
with the timing helpers of this tree's `deflate_compression_tpu_torch/
ops/timing.py` (loaded by path, so every tree is timed alike):

  * the encoder's histogram call, `core.huffman.histogram_rows` on int64
    symbols at (32, 32768), C = 286 and 30, random and one symbol per row,
    and `ops.histogram.tile_histogram` on int32: device ms per call (100
    calls queued behind a spin kernel), ms per call, and the kernels one
    call launches (torch.profiler);
  * `ops.decode_symbols.decode_symbols` over the flat batch of the 8.5 MB
    corpus: ms per call, queued device ms where the call lets the device
    run ahead, and the kernel's profiler ms;
  * encode MB/s (second `ZlibCodec.compress`), ratio, and verified-decode
    MB/s (one flat `decode_blocks_batch` plus adler32 per shard; the
    median of 11 runs after a warm-up, and every run);
  * the encoder's LZ77 kernels at a 1 MB and a 4 MB shard of
    `corpus.build_corpus`: `find_matches` and `lz_parse` (the int64 calls
    every tree has), device ms per call (20 calls queued behind a spin
    kernel) and profiler ms by kernel name, `tokenize`'s host ms per call
    (median of 10, each ended by a synchronize), torch's stable sort of
    the shard's hash keys as int32 and as int16 (device ms); and, where
    the tree has them, the same for the packed calls tokenize makes
    (`find_matches_packed`, `lz_parse_packed`);
  * the decoder's phase kernels on the flat batch of the 8.5 MB corpus in
    1 MB shards and of the 32 MB corpus in 4 MB shards, called as the
    decode calls them: `ops.build_tables.build_tables` and
    `ops.copy_sources.resolve_bytes`, device ms per call (20 calls queued
    behind a spin kernel) and profiler ms by kernel name; the gather
    rounds resolve_bytes ran where the tree reports them, the rounds its
    plain version runs, and the rounds bound;
  * the encoder's block stage and back end at a 1 MB and a 4 MB shard of
    `corpus.build_corpus`: encode_shard's host ms (median of 10 after a
    warm-up, each ended by a synchronize), the peak device memory one
    encode_shard allocates above what was allocated before it, and a
    SHA-256 of its words, total_bits and stats; where the tree's
    encode_shard has the `_marks` seam (trees before the port's spans),
    its stages' host ms, each ended by a synchronize
    (`profile_encode.stage_times`, best of 3: a tree before the bit-pack
    kernel has "tables and items", "block_layout", "item offsets",
    "pack64", "pack96" and "stored payloads" where a tree with it has
    "code tables" and "pack_words"), and where the tree has the port's
    spans, each stage's host ms and device ms read from its span
    "encode.<stage>" under torch.profiler with nothing synchronized
    (`profile_encode.stage_times`, the mean of 3: "stages"); and where
    the tree has them, the
    ops that encode handed its block stage and back end
    (`corpus.block_stage_inputs`: `block_plan`, `huffman_codes` at 11
    and 7 bits, and `block_layout` or `pack_words`): device ms per call
    (20 calls queued behind a spin kernel), profiler ms by kernel name
    (for pack_words also its plain version's, the torch code of the
    trees before it), a SHA-256 of each result's bytes (pack_words' words,
    total_bits, layout and token bits, which both its designs return;
    block_plan's segment costs too), and the DP's time a step: its loop's
    clock64 cycles over the tiles where the tree's kernel reports them
    (`stats["dp_cycles"]`, in ns at the card's SM clock read by
    nvidia-smi after the run), else its DP kernel's profiler time over
    the tiles. The first process says whether every tree's hashes agree
    on the rows the trees share.

With `--phases-only` a process measures the decoder's phase kernels
alone, with `--block-stage-only` the block stage alone (for trees that
differ only in those kernels). Every process prints one JSON line; the
first process prints them all and, given `--out FILE`, writes them there
as one JSON list. Needs a CUDA card.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
CORPUS_BYTES = 8_500_000
# pack_words' result fields that every tree with the kernel returns (the
# two-pass kernel returned off_pos where the one-pass kernel returns the
# decode entries; encode_shard's hash covers both through sub_*)
PACK_SHARED = ("words", "total_bits", "block_base", "pad", "token_bits")


def _helpers():
    """cuda_ms, device_ms and profiled_ms of this tree's timing module."""
    spec = importlib.util.spec_from_file_location(
        "_turns_timing", HERE / "deflate_compression_tpu_torch" / "ops" /
        "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: Path, only: str | None = None) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(tree))     # ahead of this script's folder
    from deflate_compression_tpu_torch import CodecConfig
    from deflate_compression_tpu_torch.core import huffman
    from deflate_compression_tpu_torch.core.checksum import adler32_torch
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.format.deflate import out_words
    from deflate_compression_tpu_torch.models.codec import (ZlibCodec,
                                                            compress_stream)
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import histogram as H
    import deflate_compression_tpu_torch as pkg
    if not str(Path(pkg.__file__).resolve()).startswith(str(tree)):
        raise AssertionError(f"imported {pkg.__file__}, not {tree}'s")
    T = _helpers()
    dev = torch.device("cuda")
    res = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    if only == "--block-stage-only":
        res["block_stage"] = block_stage_times(T, dev)
        return res
    res["phases"] = phase_times(T, dev)
    if only == "--phases-only":
        return res

    def kernels_of(fn):
        return sorted(k for k in T.profiled_ms(fn, 5))

    rng = np.random.default_rng(7)
    for C in (286, 30):
        rnd = torch.from_numpy(rng.integers(-1, C + 5, (32, 32768))).to(dev)
        skew = (torch.arange(32, device=dev).unsqueeze(1) * 7 % C).expand(
            32, 32768).contiguous()
        for label, sym in (("random", rnd), ("skewed", skew)):
            fn = lambda: huffman.histogram_rows(sym, C)  # noqa: E731
            if not torch.equal(fn().long(), H.tile_histogram_ref(
                    sym.int(), C).long()):
                raise AssertionError(f"histogram_rows wrong at C={C}")
            res[f"rows_int64_c{C}_{label}"] = {
                "device_ms": T.device_ms(fn, 100)[0],
                "call_ms": T.cuda_ms(fn), "kernels": kernels_of(fn)}
        s32 = rnd.int()
        fn = lambda: H.tile_histogram(s32, C)  # noqa: E731
        res[f"tile_int32_c{C}"] = {"device_ms": T.device_ms(fn, 100)[0],
                                   "call_ms": T.cuda_ms(fn)}

    raw = build_corpus(CORPUS_BYTES)
    cfg = CodecConfig()
    codec = ZlibCodec(cfg, device="cuda")
    codec.compress(raw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = codec.compress(raw)
    torch.cuda.synchronize()
    res["encode_mb_s"] = len(raw) / (time.perf_counter() - t0) / 1e6
    res["ratio"] = len(blob) / len(raw)

    S = cfg.shard_size
    flat, _, batch, valid = flat_decode_batch(raw, cfg, dev)
    nsh = len(valid)
    args = DI.phase_b_args(DI.plan(**flat), nsh * S, 32768)
    fn = lambda: DS.decode_symbols(*args)  # noqa: E731
    dms, held = T.device_ms(fn, 20)
    prof = T.profiled_ms(fn, 5)
    res["decode_symbols"] = {
        "call_ms": T.cuda_ms(fn), "device_ms": dms, "held": held,
        "kernel_prof_ms": sum(v for k, v in prof.items()
                              if "decode_symbols_kernel" in k),
        "all_prof_ms": sum(prof.values())}

    want = [zlib.adler32(raw[i * S:(i + 1) * S]) for i in range(nsh)]

    def verified():
        r = DI.decode_blocks_batch(*batch, valid, S)
        ads = torch.stack([adler32_torch(r["out"][i], valid[i])
                           for i in range(nsh)]).tolist()
        if not bool(r["ok"]) or ads != want:
            raise AssertionError("verified decode failed")
    verified()
    runs = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verified()
        torch.cuda.synchronize()
        runs.append(len(raw) / (time.perf_counter() - t0) / 1e6)
    res["verified_decode_mb_s"] = float(np.median(runs))
    res["verified_decode_mb_s_runs"] = runs
    res["lz77"] = lz77_times(T, dev)
    res["block_stage"] = block_stage_times(T, dev)
    return res


def leaves(x) -> list:
    """The tensors of a kernel's result (a tensor or nested tuples)."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in leaves(y)]


def kernels_by_name(T, fn) -> dict:
    """Profiler ms per call of fn, summed by kernel name."""
    import re
    out = {}
    for k, v in T.profiled_ms(fn, 5).items():
        k = re.search(r"\w*(_kernel|Kernel)|$", k).group() or k[:30]
        out[k] = out.get(k, 0.0) + v
    return out


def flat_decode_batch(raw: bytes, cfg, dev):
    """The flat decode_blocks_batch arguments of raw encoded in the
    config's shards (every shard's words and index on the card), and the
    flat decode's output size."""
    import numpy as np
    import torch
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.format.deflate import out_words
    from deflate_compression_tpu_torch.models.codec import compress_stream
    S = cfg.shard_size
    sink = []
    pieces = list(compress_stream([raw], cfg, index_sink=sink, device=dev))
    nsh = len(sink)
    words = np.zeros((nsh, out_words(S)), np.int64)
    for i, part in enumerate(pieces[1:-1]):
        padded = part + bytes(-len(part) % 4)
        words[i, :len(padded) // 4] = np.frombuffer(padded, "<u4")
    keys = ("block_bit_base", "block_out_start", "btype", "n_blocks",
            "sub_bit", "sub_out", "sub_blk")
    batch = [torch.from_numpy(words).to(dev)] + [
        torch.from_numpy(np.stack([st[k] for st, _, _ in sink])).to(dev)
        for k in keys]
    valid = [v for _, _, v in sink]
    return DI.flat_batch(*batch, valid, S), nsh * S, batch, valid


def phase_times(T, dev) -> dict:
    """The decoder's phase kernels block of a tree's line (see the
    module's docstring)."""
    import torch
    from deflate_compression_tpu_torch import CodecConfig
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    out = {}
    for label, n, shard in (("1mb", CORPUS_BYTES, 1 << 20),
                            ("4mb", 32 << 20, 4 << 20)):
        flat, S, _, _ = flat_decode_batch(
            build_corpus(n), CodecConfig(shard_size=shard), dev)
        p = DI.plan(**flat)
        tok = DI.phase_b(p, S, 32768).tok
        a_args = (p.w, p.blk_bit, flat["blk_btype"],
                  torch.tensor(flat["n_blocks"], device=dev))
        c_args = (p.w, tok, p.blk_bit, p.blk_out, p.blk_end, p.a.blive,
                  p.a.is_sto, S)
        bt = lambda: BT.build_tables(*a_args)  # noqa: E731
        cs = lambda: CS.resolve_bytes(*c_args)  # noqa: E731
        r = {"positions": S, "block_slots": int(p.blk_bit.numel()),
             "build_tables_ms": T.device_ms(bt, 20)[0],
             "build_tables_prof": kernels_by_name(T, bt),
             "resolve_bytes_ms": T.device_ms(cs, 20)[0],
             "resolve_bytes_prof": kernels_by_name(T, cs),
             "rounds_bound": CS.max_rounds(S)}
        try:
            stats = {}
            CS.resolve_bytes(*c_args, stats=stats)
            r["rounds_run"] = stats.pop("rounds")
            if stats:
                r["kernel_stats"] = stats
        except TypeError:           # a tree whose kernels do not report it
            r["rounds_run"] = None
        # both kernels held against their plain versions (on the CPU)
        cpu = [x.cpu() if isinstance(x, torch.Tensor) else x
               for x in (*a_args, *c_args)]
        stats = {}
        for got, want in ((bt(), BT.build_tables_ref(*cpu[:4])),
                          (cs(), CS.resolve_bytes_ref(*cpu[4:],
                                                      stats=stats))):
            for g, x in zip(leaves(got), leaves(want)):
                if not torch.equal(g.cpu(), x):
                    raise AssertionError(f"{label}: a phase kernel != plain")
        r["plain_rounds"] = len(stats["tagged"])
        out[label] = r
    return out


def host_ms(fn) -> float:
    """Median host milliseconds of fn() over 10 calls after a warm-up,
    each ended by a synchronize."""
    import numpy as np
    import torch
    times = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def block_stage_times(T, dev) -> dict:
    """The block-stage block of a tree's line (see the module's
    docstring)."""
    import inspect

    import numpy as np
    import torch
    from deflate_compression_tpu_torch import corpus
    from deflate_compression_tpu_torch import profile_encode as PE
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.format.deflate import encode_shard
    from deflate_compression_tpu_torch.ops import block_plan as BP
    out = {}
    for label, n in (("1mb", 1 << 20), ("4mb", 4 << 20)):
        x = torch.from_numpy(np.frombuffer(build_corpus(n), np.uint8).copy()
                             ).to(dev)
        r = {"encode_shard_host_ms": host_ms(
            lambda: encode_shard(x, n, True))}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        enc = encode_shard(x, n, True)
        torch.cuda.synchronize()
        r["encode_peak_mib"] = (torch.cuda.max_memory_allocated()
                                - base) / 2**20
        r["encode"] = {"sha256": digest(
            [enc["words"][:(int(enc["total_bits"]) + 31) // 32]]
            + [v for k, v in sorted(enc.items()) if k != "words"])}
        del enc
        if "_marks" in inspect.signature(encode_shard).parameters:
            r["stages_ms"] = PE.stage_times(x, n)
        elif hasattr(PE, "span_times"):
            r["stages"] = PE.stage_times(x, n)
        for name, (op, ref, a, k) in getattr(
                corpus, "block_stage_inputs", lambda *_: {})(x, n).items():
            fn = lambda: op(*a, **k)  # noqa: E731
            r[name] = {"device_ms": T.device_ms(fn, 20)[0],
                       "prof": kernels_by_name(T, fn)}
            if name == "pack_words":
                r[name]["plain_prof_ms"] = sum(T.profiled_ms(
                    lambda: ref(*a, **k), 5).values())
            st = {} if name == "block_plan" else None
            got = BP.block_plan(*a, **k, stats=st) if st is not None \
                else fn()
            if name == "pack_words":    # the fields every tree's has
                got = [getattr(got, f) for f in PACK_SHARED]
            r[name]["sha256"] = digest(leaves(got))
            if st is not None:
                M = a[0].shape[0]
                r[name]["cost_sha256"] = digest([st["cost"]])
                if "dp_cycles" in st:
                    r[name]["dp_cycles_per_step"] = int(st["dp_cycles"]) / M
                else:
                    dp = [v for kname, v in r[name]["prof"].items()
                          if "dp" in kname]
                    r[name]["dp_kernel_ns_per_step"] = (
                        dp[0] * 1e6 / M if dp else None)
        out[label] = r
    out["sm_clock_mhz"] = sm_clock_mhz()
    for r in out.values():
        cyc = r.get("block_plan", {}).get("dp_cycles_per_step") if \
            isinstance(r, dict) else None
        if cyc is not None:
            r["block_plan"]["dp_ns_per_step"] = cyc * 1e3 / out[
                "sm_clock_mhz"]
    return out


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def sm_clock_mhz() -> float:
    """The card's SM clock now, in MHz, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def lz77_times(T, dev) -> dict:
    """The LZ77 block of a tree's line (see the module's docstring)."""
    import re

    import numpy as np
    import torch
    from deflate_compression_tpu_torch.core import lz77
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.ops import find_matches as FM
    from deflate_compression_tpu_torch.ops import lz_parse as LP

    def queued(fn):
        return T.device_ms(fn, 20)[0]

    def by_name(fn):
        return kernels_by_name(T, fn)

    packed = hasattr(FM, "find_matches_packed")
    out = {}
    for label, n in (("1mb", 1 << 20), ("4mb", 4 << 20)):
        x = torch.from_numpy(np.frombuffer(build_corpus(n), np.uint8).copy()
                             ).to(dev)
        m = FM.find_matches(x, 32)
        fm = lambda: FM.find_matches(x, 32)  # noqa: E731
        lp = lambda: LP.lz_parse(x, *m, n, True)  # noqa: E731
        r = {"find_matches_ms": queued(fm), "find_matches_prof": by_name(fm),
             "lz_parse_ms": queued(lp), "lz_parse_prof": by_name(lp),
             "tokenize_host_ms": host_ms(lambda: lz77.tokenize(x, n))}
        d = x.long()
        h = ((d[:-2] | d[1:-1] << 8 | d[2:] << 16) * 2654435761
             & 0xFFFFFFFF) >> 16
        h32, h16 = h.int(), h.to(torch.int16)
        r["sort_int32_ms"] = queued(lambda: torch.sort(h32, stable=True))
        r["sort_int16_ms"] = queued(lambda: torch.sort(h16, stable=True))
        if packed:
            pm = FM.find_matches_packed(x, 32)
            fmp = lambda: FM.find_matches_packed(x, 32)  # noqa: E731
            lpp = lambda: LP.lz_parse_packed(x, pm, n, True)  # noqa: E731
            r["find_matches_packed_ms"] = queued(fmp)
            r["find_matches_packed_prof"] = by_name(fmp)
            r["lz_parse_packed_ms"] = queued(lpp)
            r["lz_parse_packed_prof"] = by_name(lpp)
        out[label] = r
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        only = [a for a in argv[2:] if a.endswith("-only")]
        print(json.dumps(child(Path(argv[1]).resolve(),
                               only[0] if only else None)))
        return 0
    flags = [a for a in argv if a in ("--phases-only", "--block-stage-only")]
    argv = [a for a in argv if a not in flags]
    out_file = None
    if "--out" in argv:
        i = argv.index("--out")
        out_file = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--child",
                              str(Path(tree).resolve()), *flags],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    hashes = [{(size, name, key): v for size, r in row["block_stage"].items()
               if isinstance(r, dict)
               for name, o in r.items() if isinstance(o, dict)
               for key, v in o.items() if key.endswith("sha256")}
              for row in rows if "block_stage" in row]
    if hashes:
        shared = set.intersection(*(set(h) for h in hashes))
        same = all(h[k] == hashes[0][k] for h in hashes for k in shared)
        print(f"results bit-identical across the trees on the rows they "
              f"share ({sorted(shared)}): {same}", flush=True)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
