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


def _flat_plan(out_size: int, copies: int = 5):
    """flat_batch and plan (phase A and the lanes, no phase C) of `copies`
    copies of one encoded 64 KB shard at `out_size` output bytes per shard;
    also the lane ends the old constant sentinel 1 << 30 gave."""
    from deflate_compression_tpu_torch import corpus
    from deflate_compression_tpu_torch.format.deflate import encode_shard
    S = 1 << 16
    raw = corpus.build_corpus(S, seed=5)
    r = encode_shard(torch.from_numpy(np.frombuffer(raw, np.uint8).copy()),
                     S, True)
    keys = ("block_bit_base", "block_out_start", "btype", "n_blocks",
            "sub_bit", "sub_out", "sub_blk")
    batch = [r["words"].expand(copies, -1)] + [
        r[k].expand(copies, *r[k].shape) for k in keys]
    flat = DI.flat_batch(*batch, torch.full((copies,), S), out_size)
    p = DI.plan(**flat)
    so = torch.where(flat["sub_blk"] >= 0, flat["sub_out"], 1 << 30)
    nl = so.shape[0]
    nxt = torch.where(torch.arange(nl) + 1 < nl,
                      so[(torch.arange(nl) + 1).clamp(max=nl - 1)], 1 << 30)
    old_end = torch.minimum(nxt, p.blk_end[flat["sub_blk"].clamp(min=0)])
    return p, old_end


def test_flat_lanes_past_2_30_output_bytes_end_after_their_start():
    """Shard 4 of a batch at 2^28 bytes per shard starts at 2^30: every
    live lane still ends at or after its start (the old sentinel cut one
    lane there), and each shard's lanes are the first shard's, shifted."""
    p, old_end = _flat_plan(1 << 28)
    live = p.ln.llive
    assert bool(live.any())
    assert not bool((live & (p.ln.lane_end < p.ln.ocur)).any())
    assert bool((live & (old_end < p.ln.ocur)).any())     # the old fault
    span = (p.ln.lane_end - p.ln.ocur).view(5, -1)
    lv = live.view(5, -1)
    assert bool((lv == lv[0]).all())
    assert torch.equal(torch.where(lv, span, 0),
                       torch.where(lv, span[0], 0).expand_as(span))


def test_flat_lanes_below_2_30_unchanged_by_the_sentinel():
    """At 65536 bytes per shard every lane ends where the old constant
    sentinel ended it, and no live lane ends before its start."""
    p, old_end = _flat_plan(1 << 16)
    assert torch.equal(p.ln.lane_end, old_end)
    live = p.ln.llive
    assert bool(live.any())
    assert not bool((live & (p.ln.lane_end < p.ln.ocur)).any())


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
