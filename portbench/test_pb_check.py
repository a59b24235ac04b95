"""`correct` on the CPU at a small size: every cell's control comes out
not correct, and a run with the timed path broken underneath (an answer
altered where it is produced, half of the batch left out, the state
returned unchanged) comes out not correct too. A card test runs each
cell once at its own size."""
import json
from pathlib import Path

import pytest

from portbench import control, run

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {"shard_size": 32768, "decode_group_bytes": 32768}
PORT = "deflate_compression_tpu_torch."


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("streams")


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cache):
    res = control.control(cell, 2**31 + 5, dev="cpu", scale=300,
                          overrides=SMALL, cache_root=cache)
    assert res["correct"] is False, res["check"]
    assert any(v["value"] > 0 for v in res["check"].values()), res["check"]


def _flip(b: bytes) -> bytes:
    x = bytearray(b)
    x[len(x) // 2] ^= 0x10
    return bytes(x)


def _encode_faults(mp, fault):
    import importlib
    codec = importlib.import_module(PORT + "models.codec")
    if fault == "altered":
        orig = codec.shard_bytes
        mp.setattr(codec, "shard_bytes", lambda r: _flip(orig(r)))
    elif fault == "half":
        orig = codec.encode_shards

        def half(raw, S, *a, **k):
            shards = list(orig(raw, S, *a, **k))
            return shards[:max(1, len(shards) // 2)]
        mp.setattr(codec, "encode_shards", half)
    else:
        mp.setattr(codec.ZlibCodec, "compress", lambda self, d: bytes(d))


def _indexed_faults(mp, fault):
    import importlib
    idx = importlib.import_module(PORT + "decode.index")
    orig = idx.decompress_indexed
    broken = {"altered": _flip, "half": lambda b: b[:len(b) // 2],
              "unchanged": lambda b: bytes(len(b))}[fault]
    mp.setattr(idx, "decompress_indexed",
               lambda *a, **k: broken(orig(*a, **k)))


def _device_faults(mp, fault):
    import importlib
    di = importlib.import_module(PORT + "decode.device_inflate")
    orig = di.decode_blocks_batch

    def broken(*a, **k):
        r = orig(*a, **k)
        out = r["out"].clone()
        if fault == "altered":
            out[0, out.shape[1] // 7] ^= 0x10
        elif fault == "half":
            out[out.shape[0] // 2:] = 0
            out[:, out.shape[1] // 2:] = 0
        else:
            out.zero_()
        return {**r, "out": out}
    mp.setattr(di, "decode_blocks_batch", broken)


FAULTS = {"encode": _encode_faults, "indexed_decode": _indexed_faults,
          "device_decode": _device_faults}


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, cache, monkeypatch):
    entry = json.loads((ROOT / "portbench" / "traffic" /
                        f"{cell.split('.')[1]}.json").read_text())["entry"]
    # the streams are cached by a sound run first, so only the timed
    # path runs broken
    assert run.run(cell, 11, 0, False, device="cpu", scale=300,
                   overrides=SMALL, cache_root=cache)[0]["correct"]
    FAULTS[entry](monkeypatch, fault)
    res, _ = run.run(cell, 11, 0, False, device="cpu", scale=300,
                     overrides=SMALL, cache_root=cache)
    assert res["correct"] is False, res["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    res, _ = run.run(cell, 2**31 + 17, 0, False)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"


def test_decode_content_is_drawn_from_the_seed():
    """A decode cell's run decodes one of its traffic's contents, drawn
    from the seed; a dozen seeds cover them all."""
    from portbench.entries import content_seed
    traffic = {"content_seeds": [17, 18, 19, 20]}
    got = [content_seed(traffic, 2**31 + s) for s in range(12)]
    assert set(got) == {17, 18, 19, 20}
    assert got == [content_seed(traffic, 2**31 + s) for s in range(12)]
