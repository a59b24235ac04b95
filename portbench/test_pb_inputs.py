"""The input generator: exact Silesia sizes, a seed repeats byte for byte,
two seeds differ, and nothing outside this folder is read."""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import inputs

HERE = Path(__file__).resolve().parent
SILESIA = {"dickens": 10192446, "mozilla": 51220480, "mr": 9970564,
           "nci": 33553445, "ooffice": 6152192, "osdb": 10085684,
           "reymont": 6627202, "samba": 21606400, "sao": 7251944,
           "webster": 41458703, "xml": 5345280, "x-ray": 8474240}


def test_objects_are_the_silesia_files_in_order():
    objs = inputs.objects()
    assert [o["name"] for o in objs] == list(SILESIA)
    assert sum(o["size"] for o in objs) == 211_938_580
    assert {o["kind"] for o in objs} <= set(inputs.KINDS)


def test_sizes_exact_and_seed_repeats():
    a = inputs.make(2**31 + 12345)
    assert [len(x) for x in a] == list(SILESIA.values())
    b = inputs.make(2**31 + 12345)
    assert [hashlib.sha256(x).digest() for x in a] == \
        [hashlib.sha256(x).digest() for x in b]


def test_two_seeds_differ_in_every_object():
    a = inputs.make(7, scale=100)
    b = inputs.make(8, scale=100)
    assert all(x != y for x, y in zip(a, b))
    assert [len(x) for x in a] == [len(x) for x in b]


def test_kinds_keep_their_character():
    import numpy as np
    objs = dict(zip(SILESIA, inputs.make(3, scale=50)))
    assert b"\n" in objs["dickens"] and b"{" in objs["samba"]
    assert len(set(objs["mr"][0::3])) <= 64                # a palette
    rng = np.random.default_rng(1)
    p = inputs.sample("periodic", 4096, rng).tobytes()
    assert p[:64] * 4 == p[:256]                           # tiled pattern
    z = inputs.sample("zeros", 1 << 16, rng).tobytes()
    assert z.count(0) > 0.9 * len(z)                       # zero runs


@pytest.mark.parametrize("kind", ["text", "cpp"])
def test_text_kinds_do_not_repeat_inside_the_window(kind):
    """A fresh line order for every repeat of the snapshot: no 32 KiB
    stretch is a copy of the one a snapshot's length before it."""
    import numpy as np
    n = len(inputs.snapshot(kind))
    a = inputs.sample(kind, 4 * n + (1 << 16), np.random.default_rng(9))
    assert sorted(a[:n].tobytes().split(b"\n")[1:-1]) != []
    for at in (n, 2 * n, 3 * n):
        assert a[at:at + (1 << 15)].tobytes() != \
            a[at - n:at - n + (1 << 15)].tobytes()


def test_zlib6_ratio_near_the_silesia_files():
    """Each kind's zlib level-6 ratio lies near its namesake's (0.09-0.38
    for all but sao and x-ray), so no object is coded as one run of
    copies."""
    import zlib
    for o, b in zip(inputs.objects(), inputs.make(4, scale=40)):
        r = len(zlib.compress(b, 6)) / len(b)
        assert (0.95 if o["kind"] == "random" else 0.08) < r < 1.01, \
            (o["name"], r)


def test_generator_reads_only_its_folder():
    code = f"""
import sys
sys.path.insert(0, {str(HERE.parent)!r})
import numpy
import pytest

from portbench import inputs
seen = []
sys.addaudithook(lambda ev, args: seen.append(str(args[0]))
                 if ev == "open" and isinstance(args[0], str) else None)
inputs.make(5, scale=1000)
print(__import__("json").dumps(seen))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    opened = json.loads(out.strip().splitlines()[-1])
    assert opened, "the audit hook saw no file"
    # module imports from the interpreter's own folders are code, not data
    lib = {Path(p).resolve() for p in (sys.prefix, sys.base_prefix)}
    outside = [p for p in opened
               if not Path(p).resolve().is_relative_to(HERE)
               and not any(Path(p).resolve().is_relative_to(d) for d in lib)]
    assert outside == []
