"""The port's own copies of the format constants, the codec configuration,
the error types and the native index bridge, held against the JAX
package's."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deflate_compression_tpu import native_bridge as jnb
from deflate_compression_tpu.format import constants as JC
from deflate_compression_tpu.utils import config as jcfg
from deflate_compression_tpu.utils import errors as jerr
from deflate_compression_tpu_torch import native_bridge as tnb
from deflate_compression_tpu_torch.format import constants as TC
from deflate_compression_tpu_torch.utils import config as tcfg
from deflate_compression_tpu_torch.utils import errors as terr

ROOT = Path(__file__).resolve().parent.parent

_PUBLIC = sorted(n for n in dir(JC) if n.isupper())


def test_constants_cover_the_jax_package():
    assert sorted(n for n in dir(TC) if n.isupper()) == _PUBLIC


@pytest.mark.parametrize("name", _PUBLIC)
def test_constant_equals_jax(name):
    want, got = getattr(JC, name), getattr(TC, name)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_config_fields_and_defaults_match_jax():
    tf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(tcfg.CodecConfig)]
    jf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(jcfg.CodecConfig)]
    assert tf == jf
    assert tcfg.BLOCK_SIZE == jcfg.BLOCK_SIZE
    assert dataclasses.asdict(tcfg.DEFAULT_CONFIG) == \
        dataclasses.asdict(jcfg.DEFAULT_CONFIG)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcfg.DEFAULT_CONFIG.shard_size = 1


@pytest.mark.parametrize("kwargs", [
    {"shard_size": 0}, {"shard_size": -32768}, {"shard_size": 32769},
    {"container": "zip"}, {"num_candidates": 0}, {"num_candidates": 65},
    {"block_type": "huffman"},
])
def test_config_rejects_like_jax(kwargs):
    with pytest.raises(ValueError) as te:
        tcfg.CodecConfig(**kwargs)
    with pytest.raises(ValueError) as je:
        jcfg.CodecConfig(**kwargs)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("block_type", ["auto", "stored", "fixed", "dynamic"])
def test_config_force_btype_matches_jax(block_type):
    kw = dict(shard_size=3 * 32768, num_candidates=8, lazy=False,
              container="raw", block_type=block_type)
    assert tcfg.CodecConfig(**kw).force_btype == \
        jcfg.CodecConfig(**kw).force_btype


@pytest.mark.parametrize("name", ["E_HDR", "E_ADLER", "E_INDEX",
                                  "E_SELFCHECK", "E_UNKNOWN"])
def test_deflate_error_code_and_message_match_jax(name):
    t, j = terr.DeflateError(name, "msg"), jerr.DeflateError(name, "msg")
    assert (t.name, t.code, str(t)) == (j.name, j.code, str(j))
    assert isinstance(t, terr.CodecError)
    assert not isinstance(t, jerr.CodecError)


@pytest.mark.parametrize("name", ["E_SIG", "E_CRC", "E_IDAT", "E_FILTER",
                                  "E_EOF", "E_UNKNOWN"])
def test_png_error_code_and_message_match_jax(name):
    t, j = terr.PngError(name, "msg"), jerr.PngError(name, "msg")
    assert (t.name, t.code, str(t)) == (j.name, j.code, str(j))
    assert isinstance(t, terr.CodecError)


@pytest.mark.parametrize("name", ["E_MESH", "E_SHARD", "E_GATHER",
                                  "E_RESUME", "E_UNKNOWN"])
def test_dist_error_code_and_message_match_jax(name):
    t, j = terr.DistError(name, "msg"), jerr.DistError(name, "msg")
    assert (t.name, t.code, str(t)) == (j.name, j.code, str(j))
    assert terr.DOMAIN_DIST == jerr.DOMAIN_DIST
    assert isinstance(t, terr.CodecError)
    assert not isinstance(t, jerr.CodecError)


def test_native_index_matches_jax_bridge():
    import zlib
    raw = (b"native index pass of the port " * 4000)[:100_000]
    body = zlib.compress(raw, 9)[2:-4]
    assert tnb.available() and jnb.available()
    got = tnb.build_index_native(body, 0, 1024)
    want = jnb.build_index_native(body, 0, 1024)
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g, w)
    assert got[6] == want[6] == len(raw)
    with pytest.raises(terr.DeflateError):
        tnb.build_index_native(b"\x07" + body[1:], 0, 1024)


_BUILD = r"""
import sys
from pathlib import Path
from deflate_compression_tpu_torch import native_bridge as nb
nb.BUILD_DIR = Path(sys.argv[1])
print(nb.build())
"""


def test_native_build_is_its_own_and_race_free(tmp_path):
    """Four processes build into one fresh directory at once: one library,
    published whole, none in native/, no temporary file left."""
    assert tnb.lib_path().parent == tnb.BUILD_DIR
    assert tnb.BUILD_DIR.parent.name == "deflate_compression_tpu_torch"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    paths = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1
    built = Path(paths.pop())
    assert built.parent == tmp_path and built.stat().st_size > 0
    assert sorted(x.name for x in tmp_path.iterdir()) == \
        sorted([built.name, "native.lock"])
