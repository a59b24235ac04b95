"""Port parity: the data-parallel encode (parallel/dist.py) without a
process group and in gloo worlds of 1, 2 and 4 ranks on the CPU, against
the JAX package's compress_distributed on the 8-device CPU mesh and the
port's own codecs, for the same 32 KB shard plan; and the launcher
(parallel/launcher.py).

Tolerance: identical bytes (the container, and the .dcx index bytes).
Inputs are made from a seed by `corpus.build_corpus`. Each gloo world runs
every case once in its own processes (a `file://` store under tmp_path),
where `jax` and the JAX package cannot be imported; the JAX side runs in
the test process. Every world has a time limit well inside the suite's."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
S = 32768
WORLD_TIMEOUT_S = 240

# case -> (input bytes, seed, container, force_btype, return_index)
CASES = {
    "zlib": (5 * S + 1234, 3, "zlib", None, False),
    "gzip": (2 * S + 777, 4, "gzip", None, False),
    "raw": (3 * S + 5, 5, "raw", None, False),
    "multi_wave": (9 * S + 4321, 6, "zlib", None, False),
    "exact_multiple": (4 * S, 7, "zlib", None, False),
    "empty": (0, 0, "zlib", None, False),
    "force_fixed": (2 * S + 100, 8, "zlib", 1, False),
    "index": (5 * S + 1234, 3, "zlib", None, True),
}
RETRY_CASE = "zlib"
BTYPE_NAME = {None: "auto", 0: "stored", 1: "fixed", 2: "dynamic"}


def case_input(name: str) -> bytes:
    from deflate_compression_tpu_torch import corpus
    n, seed = CASES[name][:2]
    return corpus.build_corpus(n, seed=seed) if n else b""


def run_cases(mesh) -> dict:
    """Every case, the retried fault and the fault that never clears
    through the port's compress_distributed on `mesh`. Indexes come back
    as their .dcx bytes; errors as (name, code, hook calls)."""
    from deflate_compression_tpu_torch.parallel.dist import \
        compress_distributed
    from deflate_compression_tpu_torch.utils.errors import DistError
    out = {}
    for name, (_, _, container, fb, idx) in CASES.items():
        r = compress_distributed(case_input(name), mesh, shard_size=S,
                                 container=container, force_btype=fb,
                                 return_index=idx)
        out[name] = (r[0], r[1].to_bytes()) if idx else r
    last = mesh.world - 1

    calls = []

    def flaky(wave, attempt):           # the last rank fails once
        calls.append((wave, attempt))
        if mesh.rank == last and (wave, attempt) == (0, 0):
            raise RuntimeError("injected fault")
    out["retry"] = (compress_distributed(case_input(RETRY_CASE), mesh,
                                         shard_size=S, _fault_hook=flaky),
                    calls)

    hard = []

    def broken(wave, attempt):          # the last rank never recovers
        hard.append((wave, attempt))
        if mesh.rank == last:
            raise RuntimeError("permanent fault")
    try:
        compress_distributed(case_input(RETRY_CASE), mesh, shard_size=S,
                             max_retries=1, _fault_hook=broken)
        out["exhausted"] = None
    except DistError as e:
        out["exhausted"] = (e.name, e.code, hard)
    return out


_WORKER = r"""
import pickle, sys
sys.modules["jax"] = None
sys.modules["deflate_compression_tpu"] = None
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[5])
import test_torch_parallel as T
from deflate_compression_tpu_torch.parallel.dist import make_mesh
from deflate_compression_tpu_torch.parallel.launcher import init_distributed
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
info = init_distributed(f"file://{store}", world, rank, device="cpu",
                        timeout_s=120)
assert info["process_count"] == world and info["process_index"] == rank
res = T.run_cases(make_mesh(info["group"], "cpu"))
assert not any(m.startswith(("jax", "deflate_compression_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
with open(out, "wb") as f:
    pickle.dump(res, f)
torch.distributed.destroy_process_group()
print("RANK_OK", rank)
"""


def start_worlds(worlds, tmp: Path) -> dict:
    """Start a gloo world of each size on the CPU, all at once; every rank
    runs `run_cases`. Returns (world, rank) -> its process."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return {(w, r): subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(w), str(tmp / f"s{w}"),
         str(tmp / f"w{w}_r{r}.pkl"), str(ROOT / "tests")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in worlds for r in range(w)}


def collect_worlds(procs: dict, tmp: Path) -> dict:
    """Wait for the ranks of `start_worlds` (each within WORLD_TIMEOUT_S)
    and return world -> every rank's results, in rank order."""
    try:
        outs = {k: p.communicate(timeout=WORLD_TIMEOUT_S)
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    res = {}
    for (w, r), p in sorted(procs.items()):
        so, se = outs[(w, r)]
        assert p.returncode == 0 and f"RANK_OK {r}" in so, se[-3000:]
        with open(tmp / f"w{w}_r{r}.pkl", "rb") as f:
            res.setdefault(w, []).append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """world -> every rank's run_cases results; world 0 is no process group
    (in this process, while the gloo worlds run)."""
    import torch
    from deflate_compression_tpu_torch.parallel.dist import make_mesh
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("worlds")
    procs = start_worlds((1, 2, 4), tmp)
    try:
        alone = run_cases(make_mesh(device="cpu"))
    finally:
        res = collect_worlds(procs, tmp)
    return {0: [alone], **res}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's compress_distributed of every case on the
    conftest's 8-device CPU mesh, with the retried fault."""
    import jax
    from deflate_compression_tpu.parallel import dist as jdist
    mesh = jdist.make_mesh(jax.devices()[:8])
    out = {}
    for name, (_, _, container, fb, idx) in CASES.items():
        r = jdist.compress_distributed(case_input(name), mesh, shard_size=S,
                                       container=container, force_btype=fb,
                                       return_index=idx)
        out[name] = (r[0], r[1].to_bytes()) if idx else r
    calls = []

    def flaky(wave, attempt):
        calls.append((wave, attempt))
        if (wave, attempt) == (0, 0):
            raise RuntimeError("injected fault")
    out["retry"] = (jdist.compress_distributed(
        case_input(RETRY_CASE), mesh, shard_size=S, _fault_hook=flaky),
        calls)
    return out


def port_codec(name: str):
    """The port's single-device codec (or, with an index, compress_stream
    and index_from_shards) on the same shard plan."""
    from deflate_compression_tpu_torch import (CodecConfig, compress_stream,
                                               index_from_shards, make_codec)
    _, _, container, fb, idx = CASES[name]
    cfg = CodecConfig(shard_size=S, container=container,
                      block_type=BTYPE_NAME[fb])
    raw = case_input(name)
    if idx:
        sink = []
        blob = b"".join(compress_stream([raw], cfg, index_sink=sink,
                                        device="cpu"))
        return blob, index_from_shards(*zip(*sink)).to_bytes()
    return make_codec(cfg, device="cpu").compress(raw)


WORLDS = [0, 1, 2, 4]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_matches_jax_and_codec(port, jax_ref, case, world):
    want = jax_ref[case]
    for r, res in enumerate(port[world]):
        assert res[case] == want, f"rank {r}"
    assert port_codec(case) == want


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_output_decodes(port, world):
    import gzip
    import zlib
    res = port[world][0]
    for name in CASES:
        blob = res[name][0] if CASES[name][4] else res[name]
        raw = case_input(name)
        container = CASES[name][2]
        if container == "gzip":
            assert gzip.decompress(blob) == raw
        else:
            assert zlib.decompress(blob, wbits=15 if container == "zlib"
                                   else -15) == raw


@pytest.mark.parametrize("world", WORLDS)
def test_retried_fault_gives_the_same_bytes(port, jax_ref, world):
    for res in port[world]:
        blob, calls = res["retry"]
        assert blob == res[RETRY_CASE] == jax_ref["retry"][0]
        assert calls[:2] == [(0, 0), (0, 1)]
    assert jax_ref["retry"][1][:2] == [(0, 0), (0, 1)]


@pytest.mark.parametrize("world", WORLDS)
def test_fault_that_never_clears_raises_on_every_rank(port, world):
    from deflate_compression_tpu.utils.errors import DistError as JaxDist
    want = JaxDist("E_SHARD")
    for res in port[world]:
        assert res["exhausted"] is not None
        name, code, calls = res["exhausted"]
        assert (name, code) == (want.name, want.code)
        assert calls == [(0, 0), (0, 1)]


def test_unknown_container_raises():
    from deflate_compression_tpu_torch.parallel.dist import (
        compress_distributed, make_mesh)
    with pytest.raises(ValueError):
        compress_distributed(b"x", make_mesh(device="cpu"), container="zip")


def test_launcher_single_process():
    from deflate_compression_tpu.parallel import launcher as jl
    from deflate_compression_tpu_torch.parallel.launcher import (
        host_shard_indices, init_distributed)
    info = init_distributed(device="cpu")
    assert info["group"] is None and str(info["device"]) == "cpu"
    assert (info["process_index"], info["process_count"],
            info["local_devices"], info["global_devices"]) == (0, 1, 1, 1)
    for args in [(5,), (5, 0, 1), (10, 1, 4), (10, 3, 4), (3, 2, 8)]:
        assert list(host_shard_indices(*args)) == \
            list(jl.host_shard_indices(*args[:1], *(args[1:] or (0, 1))))


def test_dryrun_multichip_two_gloo_ranks():
    code = ("import sys; sys.modules['jax'] = None\n"
            "from deflate_compression_tpu_torch.parallel.launcher import "
            "dryrun_multichip\n"
            "dryrun_multichip(2, device='cpu')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=WORLD_TIMEOUT_S,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun_multichip(2): OK" in res.stdout
