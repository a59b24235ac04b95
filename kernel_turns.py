"""Time two trees of the port in turns on one CUDA card.

    python3 kernel_turns.py TREE [TREE ...] [--out FILE]

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
    MB/s (one flat `decode_blocks_batch` plus adler32 per shard).

Every process prints one JSON line; the first process prints them all and,
given `--out FILE`, writes them there as one JSON list. Needs a CUDA card.
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


def _helpers():
    """cuda_ms, device_ms and profiled_ms of this tree's timing module."""
    spec = importlib.util.spec_from_file_location(
        "_turns_timing", HERE / "deflate_compression_tpu_torch" / "ops" /
        "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: Path) -> dict:
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
    flat = DI.flat_batch(*batch, valid, S)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verified()
    torch.cuda.synchronize()
    res["verified_decode_mb_s"] = len(raw) / (time.perf_counter() - t0) / 1e6
    return res


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print(json.dumps(child(Path(argv[1]).resolve())))
        return 0
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
                              str(Path(tree).resolve())],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
