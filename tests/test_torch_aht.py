"""Port parity: the adaptive Huffman tree (core/aht.py) against the JAX
package's, insert by insert: scores, depths and interchange counts are
integers, so equality is exact; the static optimal Huffman cost of the
running histogram is the external check."""
import heapq

import numpy as np
import pytest

from deflate_compression_tpu.core import aht as jaht
from deflate_compression_tpu_torch.core import aht as taht


def _huffman_cost(counts) -> int:
    """Static optimal Huffman cost over the counts and the NYT node, a
    zero-weight leaf of the adaptive tree."""
    live = [int(c) for c in counts if c > 0] + [0]
    heapq.heapify(live)
    cost = 0
    while len(live) > 1:
        a, b = heapq.heappop(live), heapq.heappop(live)
        cost += a + b
        heapq.heappush(live, a + b)
    return cost


def _streams():
    rng = np.random.default_rng(4)
    return {
        "uniform": rng.integers(0, 286, 1500),
        "skewed": rng.zipf(1.4, 1500) % 286,
        "two": rng.integers(0, 2, 400),
        "one": np.full(60, 7),
        "dist": rng.geometric(0.15, 1200) % 30,
        "runs": np.repeat(rng.integers(0, 40, 150), rng.integers(1, 9, 150)),
    }


@pytest.mark.parametrize("name", sorted(_streams()))
def test_aht_inserts_match_jax(name):
    syms = _streams()[name]
    size = 30 if name == "dist" else 286
    t, j = taht.AdaptiveHuffmanTree(size), jaht.AdaptiveHuffmanTree(size)
    counts = np.zeros(size, np.int64)
    for i, s in enumerate(syms):
        t.insert(int(s))
        j.insert(int(s))
        counts[s] += 1
        assert t.score == j.score
        assert t.depths() == j.depths()
        assert t.interchanges == j.interchanges
        assert t.score == _huffman_cost(counts)
        if i % 97 == 0:
            t.check()
    t.check()
    assert t.dump() == j.dump()
    assert t.dump(color=True) == j.dump(color=True)


@pytest.mark.parametrize("name", sorted(_streams()))
def test_aht_cost_trace_matches_jax(name):
    syms = _streams()[name]
    size = 30 if name == "dist" else 286
    got = taht.aht_cost_trace(syms, size)
    assert got == jaht.aht_cost_trace(syms, size)
    assert len(got) == len(syms) and got == sorted(got)
