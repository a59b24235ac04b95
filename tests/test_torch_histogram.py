"""Port parity: per-tile histogram (ops/histogram.py) against the JAX
Pallas kernel in interpret mode and the JAX one-hot matmul twin. Counts
are integers: exact equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.core import huffman as jhuff
from deflate_compression_tpu.ops.histogram_pallas import tile_histogram as jax_tile_hist
from deflate_compression_tpu_torch.ops import histogram as H

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _symbols(rows, length, nc, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, nc + 4, (rows, length)).astype(np.int32)


@pytest.mark.parametrize("nc", [286, 30])
def test_ref_matches_pallas_interpret(nc):
    tile = 2048
    sym = _symbols(8, tile, nc, seed=nc)
    want = np.asarray(jax_tile_hist(jnp.asarray(sym.reshape(-1)), nc, tile,
                                    interpret=jax.default_backend() != "tpu"))
    got = H.tile_histogram_ref(torch.from_numpy(sym), nc).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,nc", [(4, 286), (4, 30), (1, 286)])
def test_ref_matches_onehot_matmul(rows, nc):
    sym = _symbols(rows, 32768, nc, seed=rows + nc)
    want = np.asarray(jhuff.histogram_rows_matmul(jnp.asarray(sym), nc))
    got = H.tile_histogram_ref(torch.from_numpy(sym), nc).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nc", [286, 30])
def test_int64_ref_matches_pallas_interpret(nc):
    """The encoder's int64 symbols, counted in int64, as the Pallas kernel
    counts them; values past the int32 range drop out as -1 does."""
    tile = 2048
    sym = _symbols(8, tile, nc, seed=nc + 1).astype(np.int64)
    sym[0, :5] = [-2**40, 2**33 + 3, nc + 2**32, -1, nc]
    in_range = np.where((sym >= 0) & (sym < nc), sym, -1).astype(np.int32)
    want = np.asarray(jax_tile_hist(jnp.asarray(in_range.reshape(-1)), nc,
                                    tile,
                                    interpret=jax.default_backend() != "tpu"))
    got = H.tile_histogram_ref(torch.from_numpy(sym), nc)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,length,nc", [
    (1, 1, 1), (3, 1001, 30), (5, 4099, 286), (2, 777, H.MAX_CLASSES)])
def test_ref_shapes_and_types(dtype, rows, length, nc):
    """Ragged lengths, C from 1 to MAX_CLASSES, all-one-symbol and
    all-out-of-range rows: counts equal numpy's, in the input's type."""
    rng = np.random.default_rng(rows * length + nc)
    sym = rng.integers(-3, nc + 3, (rows, length))
    sym[0] = nc - 1
    if rows > 1:
        sym[1] = rng.choice([-1, nc, nc + 7], length)
    got = H.tile_histogram(torch.from_numpy(sym).to(dtype), nc)
    assert got.dtype == dtype and got.shape == (rows, nc)
    want = np.stack([np.bincount(r[(r >= 0) & (r < nc)], minlength=nc)
                     for r in sym])
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_rows_takes_int64_in_one_call():
    from deflate_compression_tpu_torch.core import huffman as th
    sym = torch.from_numpy(_symbols(4, 32768, 286, seed=9).astype(np.int64))
    got = th.histogram_rows(sym, 286)
    assert got.dtype == torch.int64
    want = jhuff.histogram_rows_matmul(jnp.asarray(sym.numpy().astype(
        np.int32)), 286)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_on_cpu_takes_plain_version_without_launch():
    sym = torch.from_numpy(_symbols(3, 4096, 286, seed=1))
    before = H.tile_histogram.launches
    out = H.tile_histogram(sym, 286)
    assert out.dtype == torch.int32 and out.shape == (3, 286)
    assert torch.equal(out, H.tile_histogram_ref(sym, 286))
    assert H.tile_histogram.launches == before


@pytest.mark.parametrize("bad,exc", [
    (lambda: torch.zeros((2, 64), dtype=torch.int16), TypeError),
    (lambda: torch.zeros((2, 64), dtype=torch.float32), TypeError),
    (lambda: torch.zeros(64, dtype=torch.int32), ValueError),
    (lambda: torch.zeros((2, 2, 64), dtype=torch.int32), ValueError),
    (lambda: torch.zeros((64, 2), dtype=torch.int32).t(), ValueError),
])
def test_wrapper_rejects_bad_input(bad, exc):
    with pytest.raises(exc):
        H.tile_histogram(bad(), 30)


@pytest.mark.parametrize("nc", [0, H.MAX_CLASSES + 1])
def test_wrapper_rejects_bad_num_classes(nc):
    with pytest.raises(ValueError):
        H.tile_histogram(torch.zeros((2, 64), dtype=torch.int32), nc)
