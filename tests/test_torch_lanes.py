"""Port parity: the decoder's lane set-up (decode/device_inflate.py::lanes)
against the JAX decoder's formula (decode/tpu_inflate.py:462-470, restated
in numpy here), past 32,768 coding-block slots, and the table gather it
runs (ops/lut_gather.py) on tables past 32,768 entries.

Tolerance: exact. Inputs are made from a seed with numpy."""
import numpy as np
import pytest
import torch

from deflate_compression_tpu_torch.decode import device_inflate as DI
from deflate_compression_tpu_torch.ops import lut_gather as LG

OLD_CAP = 32768                  # the block slots the first gather kernel took


def lanes_case(nb: int, seed: int, nl: int = 50_000):
    """A PhaseA of nb block slots and nl sub-entry lanes (numpy, seeded),
    with lanes on blocks above OLD_CAP. Returns (a, lanes args, numpy)."""
    rng = np.random.default_rng(seed)
    huff = rng.random(nb) < 0.8
    bbad = rng.random(nb) < 0.1
    hdr_end = rng.integers(0, 1 << 40, nb)
    blk_end = rng.integers(0, 1 << 30, nb)
    sub_blk = rng.integers(-1, nb, nl)
    sub_blk[:2000] = rng.integers(OLD_CAP, nb, 2000)
    sub_out = np.sort(rng.integers(0, 1 << 30, nl))
    sub_bit = np.where(rng.random(nl) < 0.3, -1, rng.integers(0, 1 << 40, nl))
    n_subs = nl - 17
    t = torch.from_numpy
    a = DI.PhaseA(None, t(hdr_end), t(bbad), t(np.ones(nb, bool)), t(huff),
                  t(~huff))
    args = (t(sub_bit), t(sub_out), t(sub_blk), torch.tensor(n_subs),
            t(blk_end))
    ref = dict(huff=huff, bbad=bbad, hdr_end=hdr_end, blk_end=blk_end,
               sub_blk=sub_blk, sub_out=sub_out, sub_bit=sub_bit,
               n_subs=n_subs)
    return a, args, ref


def jax_lanes_formula(r):
    """tpu_inflate.py:462-470 in numpy; lblk as the port keeps it (-1 for a
    dead lane)."""
    nb, nl = len(r["huff"]), len(r["sub_blk"])
    llanes = np.arange(nl)
    lblk = np.clip(r["sub_blk"], 0, nb - 1)
    llive = (llanes < r["n_subs"]) & (r["sub_blk"] >= 0) & r["huff"][lblk]
    next_sub = np.where(llanes + 1 < r["n_subs"],
                        r["sub_out"][np.clip(llanes + 1, 0, nl - 1)], 1 << 30)
    return dict(llive=llive, lbad=llive & r["bbad"][lblk],
                lane_end=np.minimum(next_sub, r["blk_end"][lblk]),
                bp=np.where(r["sub_bit"] >= 0, r["sub_bit"],
                            r["hdr_end"][lblk]),
                lblk=np.where(llive, lblk, -1), ocur=r["sub_out"])


@pytest.mark.parametrize("nb,seed", [(40_000, 0), (70_001, 1)])
def test_lanes_past_old_block_cap_match_jax_formula(nb, seed):
    a, args, ref = lanes_case(nb, seed)
    ln = DI.lanes(a, *args)
    want = jax_lanes_formula(ref)
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(ln, k).numpy(), v, err_msg=k)
    assert int((ln.lblk >= OLD_CAP).sum()) > 1000     # the test reaches them
    assert bool(ln.lbad.any()) and bool(ln.llive.any())


@pytest.mark.parametrize("n_tbl", [65536, 1 << 20])
def test_lut_gather_cpu_takes_table_past_old_cap(n_tbl):
    rng = np.random.default_rng(n_tbl)
    tbl = torch.from_numpy(rng.integers(-2**31, 2**31, n_tbl)
                           .astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, n_tbl, 10_000).astype(np.int32))
    before = LG.lut_gather.launches
    assert torch.equal(LG.lut_gather(tbl, idx), tbl[idx.long()])
    assert torch.equal(LG.lut_gather(tbl, idx[1:]), tbl[idx[1:].long()])
    assert LG.lut_gather.launches == before


def test_lut_gather_checks_arguments():
    tbl = torch.zeros(2048, dtype=torch.int32)
    idx = torch.zeros(16, dtype=torch.int32)
    big = torch.zeros(2 * LG.MAX_TABLE, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="power of two"):
        LG.lut_gather(big, idx.to("meta"))
    with pytest.raises(ValueError, match="power of two"):
        LG.lut_gather(tbl[:3], idx)
    with pytest.raises(TypeError):
        LG.lut_gather(tbl.long(), idx)
    with pytest.raises(TypeError):
        LG.lut_gather(tbl, idx.long())
    with pytest.raises(ValueError, match="1-D"):
        LG.lut_gather(tbl, idx.view(4, 4))
    with pytest.raises(ValueError, match="1-D"):
        LG.lut_gather(tbl, torch.zeros(32, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="one device"):
        LG.lut_gather(tbl, idx.to("meta"))
