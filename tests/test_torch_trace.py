"""Port parity: the per-symbol trace (utils/trace.py) against the JAX
package's on 20 KB of repo text. The port tokenizes with its own
core/lz77.tokenize (on the CPU here); every record is integers and a ratio
printed to six places, so the CSV compares exactly."""
import numpy as np
import pytest
import torch

from deflate_compression_tpu.utils import trace as jtrace
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.utils import trace as ttrace

torch.set_num_threads(1)

TEXT = corpus.repo_text()[:20_000]


@pytest.mark.parametrize("stride,header_stride", [(1, 1), (7, 3), (50, 1),
                                                  (1, 25)])
def test_trace_csv_matches_jax(stride, header_stride):
    kw = {"stride": stride, "header_stride": header_stride}
    got = ttrace.per_symbol_trace_csv(TEXT, device="cpu", **kw)
    assert got == jtrace.per_symbol_trace_csv(TEXT, **kw)
    assert got.startswith(ttrace.CSV_HEADER + "\n")
    assert int(got.splitlines()[-1].split(",")[0]) == len(TEXT)


@pytest.mark.parametrize("kind,n,lazy", [("rgb", 12_000, True),
                                         ("periodic", 9_000, False),
                                         ("mixed", 16_384, True)])
def test_trace_records_match_jax(kind, n, lazy):
    raw = corpus.sample(kind, n, seed=2).tobytes()
    kw = {"lazy": lazy, "stride": 5, "header_stride": 4}
    got = list(ttrace.per_symbol_records(raw, device="cpu", **kw))
    assert got == list(jtrace.per_symbol_records(raw, **kw))


def test_trace_short_and_empty_inputs():
    assert ttrace.per_symbol_trace_csv(b"", device="cpu") == \
        ttrace.CSV_HEADER + "\n"
    for raw in (b"a", b"abcabcabcabc", bytes(31)):
        rows = list(ttrace.per_symbol_records(raw, device="cpu"))
        assert rows[-1][0] == len(raw)


def test_header_cost_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        ll = rng.integers(0, 16, 286) * (rng.random(286) < 0.6)
        d = rng.integers(0, 16, 30) * (rng.random(30) < 0.5)
        assert ttrace._header_cost(ll, d) == jtrace._header_cost(ll, d)
