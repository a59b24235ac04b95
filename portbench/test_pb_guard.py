"""Nothing the benchmark runs loads JAX or the JAX package, judged by the
top-level module name compared whole (the port's name begins with the
JAX package's), and the reference loads nothing of the port."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
PORT = "deflate_compression_tpu_torch"


def _modules_after(code: str) -> tuple[set, str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return set(json.loads(lines[-1])), "\n".join(lines[:-1])


@pytest.mark.parametrize("cell", CELLS)
def test_entry_path_loads_no_jax(cell, tmp_path):
    names, printed = _modules_after(f"""
from portbench import run
res, _ = run.run({cell!r}, 2**31 + 99, 0, False, device="cpu", scale=1000,
              overrides={{"shard_size": 32768,
                          "decode_group_bytes": 32768}},
              cache_root={str(tmp_path)!r})
print(res["correct"])
""")
    assert printed.endswith("True")
    assert PORT in names
    assert not names & set(run.FORBIDDEN), names & set(run.FORBIDDEN)


def test_reference_and_inputs_load_nothing_of_the_port():
    names, printed = _modules_after("""
import zlib
from portbench import inputs, reference
obj = inputs.make(3, scale=1000)[0]
print(reference.check_zlib(zlib.compress(obj), obj, 1 << 20))
""")
    assert "bytes_wrong" in printed
    assert PORT not in names
    assert not names & set(run.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    for m in list(sys.modules):
        if m.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, PORT + ".fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deflate_compression_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["deflate_compression_tpu.fake",
                                       "jaxlib"]


def test_bytecode_cache_is_in_the_checkout():
    """A run caches the bytecode it compiles at a fixed path inside the
    checkout, also where the environment turns bytecode writing off."""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; from portbench import run; "
         "run.bytecode_cache(); print(sys.pycache_prefix, "
         "sys.dont_write_bytecode)"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"PYTHONDONTWRITEBYTECODE": "1", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    prefix, off = out.stdout.split()
    assert Path(prefix) == ROOT / "portbench" / "cache" / "pyc"
    assert off == "False"
