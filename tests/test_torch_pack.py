"""The encoder's bit-pack (ops/pack_words.py) and the block layout scan
(csrc/layout_scan.cuh) on the CPU.

The CUDA kernels cannot run here, so numpy models of their algorithms
are held against the plain versions, exactly:
  * the layout scan: each block a map of p mod 8, (C, s, k) standing for
    the 8-entry table D(r) = C + s * ((k - r) mod 8), composed in the
    kernel's tree order (warp levels, then the warps' totals, chunks of
    the CTA's width in turn), against `block_layout_ref` and the serial
    `layout_model` of tests/test_torch_block_stage.py;
  * csrc/pack_words.cu, one pass: the items in closed form from the
    staged tables; each unit's aggregate (units of 4,096 positions: its
    map of p mod 8 with the block start's EOB, header bits, pad rule and
    stored bytes, its Huffman tokens, whether it starts a block); the
    decoupled look-back in several random orders of the units' steps
    (tickets in order, a few to 80 units running at once, a unit waiting
    while a status word of its batch is unwritten), each unit's prefix
    (bit position, Huffman tokens, entries, whether its block has had a
    Huffman token) held equal to the serial fold; then each unit's writes
    from its prefix: the block start's EOB, header row (11 slots a lane),
    base, pad and stored bytes (four to a word), the in-unit scan, each
    thread's run into the unit's window from bit 0 and the window's flush
    shifted by the unit's first bit mod 32, T_b, the
    decode entries at each thread's first rank in closed form, the last
    unit's EOB, tail and unused slots; every word the kernel stores (not
    ORs) checked to be touched by no other writer; against
    `pack_words_ref` on encoder shards and synthetic ones.
"""
import numpy as np
import pytest
import torch

from deflate_compression_tpu.format import deflate as jd
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.ops import block_layout as BL
from deflate_compression_tpu_torch.ops import pack_words as PW
from test_torch_block_stage import layout_model

torch.set_num_threads(1)

THREADS = 256                   # the kernels' CTA width
PER = 16                        # positions a thread
UNIT = THREADS * PER
TILE = 32768
UNIT_PER_TILE = TILE // UNIT
H_LANE = 11                     # header slots a lane


# ------------------------------------------------------- the layout scan

IDENTITY = (0, 0, 0)


def compose(f, g):
    """f, then g, as layout_scan.cuh's `compose`: (C, s, k) each."""
    cf, sf, kf = f
    cg, sg, kg = g
    if not sg:
        return (cf + cg, sf, kf)
    if not sf:
        return (cf + cg, 1, (kg - cf) & 7)
    return (cf + cg + ((kg - cf - kf) & 7), 1, kf)


def apply(m, p: int) -> int:
    """D(p mod 8) of a map."""
    c, s, k = m
    return c + (((k - p) & 7) if s else 0)


def table(m) -> list:
    """The map's 8-entry table, D(r) for r = 0..7."""
    return [apply(m, r) for r in range(8)]


def block_map(rest: int, stored: bool):
    return (int(rest), 1, 5) if stored else (int(rest), 0, 0)


def layout_scan_model(rest, stored, width: int):
    """layout_scan.cuh's `scan` with a CTA of `width` threads: chunks of
    `width` blocks, an inclusive Hillis-Steele scan in each warp, the
    warps' totals scanned by warp 0 over as many levels as the chunk has
    warps, each block's exclusive prefix evaluated at the chunk's p."""
    nb = len(rest)
    base = np.zeros(nb, np.int64)
    pad = np.zeros(nb, np.int64)
    p = 0
    for c0 in range(0, nb, width):
        left = nb - c0
        nwarps = width // 32 if left >= width else -(-left // 32)
        m = [block_map(rest[b], stored[b]) if b < nb else IDENTITY
             for b in range(c0, c0 + width)]
        incl = list(m)
        o = 1
        while o < 32:
            incl = [compose(incl[t - o], incl[t]) if t % 32 >= o else incl[t]
                    for t in range(width)]
            o *= 2
        w = [incl[32 * i + 31] for i in range(nwarps)]
        o = 1
        while o < nwarps:
            w = [compose(w[i - o], w[i]) if i >= o else w[i]
                 for i in range(nwarps)]
            o *= 2
        wex = [IDENTITY] + w[:-1]
        for t in range(min(width, left)):
            ex = incl[t - 1] if t % 32 else IDENTITY
            pre = compose(wex[t // 32], ex)
            b = c0 + t
            base[b] = p + apply(pre, p)
            pad[b] = (5 - base[b]) & 7 if stored[b] else 0
        p = p + apply(w[nwarps - 1], p)
    return base, pad, p


def standalone_width(nb: int) -> int:
    """block_layout.cu's CTA: NB rounded up to 32, at most 256."""
    return min(THREADS, -(-nb // 32) * 32)


def test_layout_map_is_the_8_entry_table():
    """Composing two maps composes their tables (r -> D_f(r) +
    D_g((r + D_f(r)) mod 8)), and composition is associative."""
    rng = np.random.default_rng(0)

    def rand_map():
        if rng.random() < 0.3:
            return IDENTITY
        return (int(rng.integers(0, 10**9)), int(rng.random() < 0.5),
                int(rng.integers(0, 8)))
    for _ in range(2000):
        f, g, h = rand_map(), rand_map(), rand_map()
        tf, tg = table(f), table(g)
        want = [tf[r] + tg[(r + tf[r]) % 8] for r in range(8)]
        assert table(compose(f, g)) == want
        assert compose(compose(f, g), h) == compose(f, compose(g, h))
    for rest in (0, 1, 7, 35, 1234567):
        m = block_map(rest, True)
        assert table(m) == [rest + (8 - (r + 3) % 8) % 8 for r in range(8)]
        assert table(block_map(rest, False)) == [rest] * 8


@pytest.mark.parametrize("name", corpus.LAYOUT_CASES)
def test_layout_scan_model_matches_plain(name):
    rest, stored = corpus.layout_case(name)
    want = BL.block_layout_ref(torch.from_numpy(rest),
                               torch.from_numpy(stored))
    serial = layout_model(rest, stored)
    for width in (standalone_width(len(rest)), THREADS):
        base, pad, p_end = layout_scan_model(rest, stored, width)
        np.testing.assert_array_equal(base, want[0].numpy())
        np.testing.assert_array_equal(pad, want[1].numpy())
        assert p_end == int(want[2]) == serial[2]
        np.testing.assert_array_equal(base, serial[0])


@pytest.mark.parametrize("nb", [1, 2, 31, 33, 255, 256, 257, 700, 2049,
                                5000])
def test_layout_scan_model_random_block_counts(nb):
    rng = np.random.default_rng(nb + 11)
    stored = rng.random(nb) < rng.random()
    rest = np.where(stored, 35 + 8 * rng.integers(0, 32769, nb),
                    rng.integers(0, 300_000, nb)).astype(np.int64)
    base, pad, p_end = layout_scan_model(rest, stored,
                                         standalone_width(nb))
    w_base, w_pad, w_end = layout_model(rest, stored)
    np.testing.assert_array_equal(base, w_base)
    np.testing.assert_array_equal(pad, w_pad)
    assert p_end == w_end
    if nb <= 300:               # the plain version walks in torch
        got = BL.block_layout(torch.from_numpy(rest),
                              torch.from_numpy(stored))
        np.testing.assert_array_equal(got[0].numpy(), w_base)


# -------------------------------------------------------- the bit-pack

def _bit_length(v: np.ndarray) -> np.ndarray:
    """floor(log2(v)) + 1 for v >= 1 (exact: frexp of an integer)."""
    return np.frexp(v.astype(np.float64))[1]


def items_model(data, chosen, length, dist, blk, huff, ll_tab, d_tab):
    """Each position's (value, width) as the kernel's `token` builds it
    from its block's staged tables."""
    S = data.shape[0]
    tb = blk[np.arange(S) // TILE]
    ln = np.clip(length, 0, 259)
    ds = np.clip(dist, 0, 32769)
    match = chosen & (ln >= 3)
    m = np.where(ln > 258, 255, ln - 3)
    k = _bit_length(np.maximum(m, 1)) - 1
    leb = np.where((m < 8) | (m >= 255), 0, k - 2)
    lcode = np.where(m < 8, 257 + m, np.where(
        m >= 255, 285, 257 + 4 * (k - 1) + ((m - (1 << k)) >> leb)))
    lev = np.where(leb > 0, m & ((1 << leb) - 1), 0)
    sym = np.where(match, lcode, data.astype(np.int64))
    t = ll_tab[tb, np.minimum(sym, 285)] & 0xFFFFFFFF
    lb = t >> 16
    v = (t & 0xFFFF) | (np.where(match, lev, 0) << lb)
    w = lb + np.where(match, leb, 0)
    x = np.where(ds < 1, 0, ds - 1)
    kd = _bit_length(np.maximum(x, 1)) - 1
    deb = np.where(x < 4, 0, kd - 1)
    dc = np.where(x < 4, x, 2 * kd + (x >> np.maximum(deb, 0)) - 2)
    dev = np.where(x < 4, 0, x & ((1 << deb) - 1))
    u = d_tab[tb, np.clip(dc, 0, 29)] & 0xFFFFFFFF
    db = u >> 16
    dv = (u & 0xFFFF) | (dev << db)
    v = np.where(match, v | (dv << w), v).astype(np.uint64)
    w = np.where(match, w + db + deb, w)
    live = chosen & huff[tb]
    w = np.where(live, w, 0)
    v = np.where(live, v & ((np.uint64(1) << w.astype(np.uint64))
                            - np.uint64(1)), 0).astype(np.uint64)
    return v, w.astype(np.int64)


class Words:
    """The writes the kernel makes to a word array (the output words, or a
    unit's shared-memory window): each an OR (atomicOr) or a store. The
    kernel's stores are only right where no other write touches the word,
    which `check` asserts."""

    def __init__(self, n: int):
        self.n = n
        self.words = np.zeros(n, np.uint64)     # the values
        self._at, self._store = [], []

    def touch(self, words, stores) -> None:
        self._at.append(np.asarray(words, np.int64).reshape(-1))
        self._store.append(np.asarray(stores, bool).reshape(-1))

    def runs(self, r0, r1) -> None:
        """`Run`s from bits r0 to r1 (arrays, one run each): the words each
        fills (the first an OR, the rest stores), then its last partial
        word (an OR); a run of no bits writes nothing."""
        r0, r1 = np.atleast_1d(r0), np.atleast_1d(r1)
        live = r1 > r0
        r0, r1 = r0[live], r1[live]
        w0, w1 = r0 >> 5, r1 >> 5
        n = w1 - w0
        first = np.repeat(w0, n)
        j = first + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        self.touch(j, j != first)
        part = (r1 & 31) != 0
        self.touch(w1[part], np.zeros(part.sum(), bool))

    def check(self) -> None:
        w = np.concatenate(self._at)
        s = np.concatenate(self._store)
        keep = w < self.n
        w, s = w[keep], s[keep]
        uniq, counts = np.unique(w, return_counts=True)
        stored = np.unique(w[s])
        c = counts[np.searchsorted(uniq, stored)]
        assert (c == 1).all(), f"words stored and written again: " \
            f"{stored[c != 1][:10]}"


def or_bits(words: np.ndarray, off: np.ndarray, v: np.ndarray,
            w: np.ndarray) -> None:
    """OR items of up to 64 bits into u32 words (int64 offsets), dropping
    words past the end."""
    keep = w > 0
    off, v, w = off[keep], v[keep].astype(np.uint64), w[keep]
    sh = (off & 31).astype(np.uint64)
    lo = v << sh
    hi = np.where(sh > 0, v >> (np.uint64(64) - sh), np.uint64(0))
    parts = [lo & np.uint64(0xFFFFFFFF), lo >> np.uint64(32),
             hi & np.uint64(0xFFFFFFFF), hi >> np.uint64(32)]
    for i, x in enumerate(parts):
        j = (off >> 5) + i
        ok = (j < words.shape[0]) & (x != 0)
        np.bitwise_or.at(words, j[ok], x[ok])


# ------------------------------------------- the look-back, as run

def mult_below(x: int, stride: int) -> int:
    """ceil(x / stride): the multiples of the stride in [0, x)."""
    return -(-x // stride)


def advance(st, agg, stride: int):
    """The kernel's `advance`: the prefix state (p, c, e, t) after a unit
    whose aggregate is (map, h, starts)."""
    p, c, e, t = st
    m, h, starts = agg
    t0 = False if starts else t
    extra = h > 0 and not t0 and c % stride != 0
    e += mult_below(c + h, stride) - mult_below(c, stride) + int(extra)
    return (p + apply(m, p), c + h, e, t0 or h > 0)


ZERO = (0, 0, 0, False)
SEG_ID = (IDENTITY, 0, False, False)


def seg_compose(f, g):
    """pack_words.cu's Seg `compose`: f, then g, each (map, Huffman tokens,
    a block starts among them, a Huffman token after the last start or
    among them if none)."""
    return (compose(f[0], g[0]), f[1] + g[1], f[2] or g[2],
            g[3] if g[2] else f[3] or g[3])


LOOK = 4                        # units a lane of the look-back holds
ROUND = 32 * LOOK               # status words a round trip


def fold_model(st, units, incl, stride: int):
    """pack_words.cu's `fold`: the state after the units of one round
    (at most ROUND in order, each (status, aggregate, unit)) from the
    state st before them. A unit whose inclusive prefix is published
    (status 2) restarts the fold after the last such; each lane composes
    its LOOK consecutive units in order, the lanes' elements are scanned
    as the warp does (Hillis-Steele, `o` = 1, 2, 4, 8, 16); each lane then
    walks its units from its exclusive prefix for their block-first
    entries; the multiples of the stride telescope."""
    k0 = 0
    for i, (status, _, j) in enumerate(units):
        if status == 2:
            st, k0 = incl[j], i + 1
    lanes = [[(m, h, starts, h > 0) for i, (_, (m, h, starts), _) in
              enumerate(units) if i >= k0 and i // LOOK == lane]
             for lane in range(32)]
    e = []
    for lane in lanes:
        x = SEG_ID
        for g in lane:
            x = seg_compose(x, g)
        e.append(x)
    inc = list(e)
    o = 1
    while o < 32:
        inc = [seg_compose(inc[i - o], inc[i]) if i >= o else inc[i]
               for i in range(32)]
        o *= 2
    p, c, ee, t = st
    n_extra = 0
    for i, lane in enumerate(lanes):
        ex = inc[i - 1] if i else SEG_ID
        ci = c + ex[1]
        ti = ex[3] if ex[2] else t or ex[3]
        for m, h, starts, _ in lane:
            t0 = False if starts else ti
            n_extra += h > 0 and not t0 and ci % stride != 0
            ci += h
            ti = t0 or h > 0
    tot = inc[31]
    c1 = c + tot[1]
    return (p + apply(tot[0], p), c1,
            ee + mult_below(c1, stride) - mult_below(c, stride) + n_extra,
            tot[3] if tot[2] else t or tot[3])


def look_back_model(aggs, stride: int, rng, resident: int) -> list:
    """Each unit's prefix state as the kernel's look-back finds it, in one
    random order of the units' steps. Units take tickets in order, at most
    `resident` of them running at once; a running unit publishes its
    aggregate (unit 0 its inclusive prefix), then looks back: ROUND status
    words at a time back to the nearest inclusive prefix, waiting while a
    word of that round is unwritten; then, in a step of its own, it folds
    the units between, ROUND at a time, from their words read again as
    they are then (some may have become inclusive prefixes); then it
    publishes its inclusive prefix. Returns the states and the aggregates the folds
    applied."""
    nu = len(aggs)
    status = [0] * nu
    incl = [None] * nu
    excl = [None] * nu
    found = {}                              # u -> (v0, its state)
    started, done, running = 0, 0, []
    applied = [0]

    def fold_from(u, v0, st, words):
        for j0 in range(v0 + 1, u, ROUND):
            units = [(words[j], aggs[j], j)
                     for j in range(j0, min(j0 + ROUND, u))]
            applied[0] += sum(w == 1 for w, _, _ in units)
            st = fold_model(st, units, incl, stride)
        return st

    def try_look_back(u):
        hi = u - 1
        while True:
            rnd = [j for j in range(hi, hi - ROUND, -1) if j >= 0]
            if any(status[j] == 0 for j in rnd):
                return None                 # a lane spins
            inc = [j for j in rnd if status[j] == 2]
            if inc:
                v0 = max(inc)
                break
            hi -= ROUND
        found[u] = (v0, incl[v0])           # folded in a later step
        return None

    while done < nu:
        if started < nu and len(running) < resident and (
                not running or rng.random() < 0.3):
            running.append(started)
            started += 1
            continue
        u = running[int(rng.integers(len(running)))]
        if status[u] == 0 and u > 0:
            status[u] = 1
            continue
        if u in found:
            v0, st = found.pop(u)
            st = fold_from(u, v0, st, status)
        else:
            st = ZERO if u == 0 else try_look_back(u)
        if st is None:
            continue
        excl[u] = st
        incl[u] = advance(st, aggs[u], stride)
        status[u] = 2
        running.remove(u)
        done += 1
    return excl, applied[0]


def unit_aggregates(args, w, tok_h):
    """Each unit's aggregate as the kernel builds it before its look-back:
    its map of p mod 8 (the block's start: the previous EOB, the header
    without the EOB, a stored block's pad rule and bytes; the unit's token
    bits; the last unit's EOB), its Huffman tokens, whether it starts a
    block; and per unit (starts, previous EOB, header bits)."""
    (_, _, _, _, blk, start, _, sto, blen, _, _, _, hdr_nbs) = args[:13]
    S = w.shape[0]
    NU = S // UNIT
    W = w.reshape(NU, UNIT).sum(1)
    h = tok_h.reshape(NU, UNIT).sum(1)
    hs = hdr_nbs[:, :PW.SLOT_EOB].sum(1)
    aggs, info = [], []
    for u in range(NU):
        tile = u // UNIT_PER_TILE
        b = int(blk[tile])
        starts = u % UNIT_PER_TILE == 0 and int(start[b]) == tile
        c, sk = int(W[u]), (0, 0)
        eprev = int(hdr_nbs[b - 1, PW.SLOT_EOB]) if starts and b > 0 else 0
        if starts:
            c += eprev + int(hs[b]) + (8 * int(blen[b]) if sto[b] else 0)
            if sto[b]:
                sk = (1, (5 - eprev) & 7)
        if u == NU - 1:
            c += int(hdr_nbs[b, PW.SLOT_EOB])
        aggs.append(((c, *sk), int(h[u]), starts))
        info.append((b, starts, eprev, int(hs[b]), int(W[u])))
    return aggs, info


def pack_model(args, final: bool, num_words: int, orders=3) -> dict:
    """csrc/pack_words.cu in numpy (see the module's docstring): the
    look-back's prefix states, the same in `orders` random orders and
    equal to the serial fold; then each unit's writes from its state."""
    (data, chosen, length, dist, blk, start, huff, sto, blen, ll_tab, d_tab,
     hdr_lo, hdr_nbs) = [np.asarray(a) for a in args[:13]]
    stride = min(max(int(args[13]), 1), 1 << 30)
    S = data.shape[0]
    NB, NU, NSUB = S // TILE, S // UNIT, S // 64
    v, w = items_model(data, chosen, length, dist, blk, huff, ll_tab, d_tab)
    tok_h = chosen & np.repeat(huff[blk], TILE)
    aggs, info = unit_aggregates(
        (data, chosen, length, dist, blk, start, huff, sto, blen, ll_tab,
         d_tab, hdr_lo, hdr_nbs), w, tok_h)
    serial = [ZERO]
    for agg in aggs:
        serial.append(advance(serial[-1], agg, stride))
    rng = np.random.default_rng(S + stride)
    applied = 0
    for _ in range(orders):
        got, n = look_back_model(aggs, stride, rng, int(rng.integers(2, 80)))
        assert got == serial[:-1]
        applied += n
    assert applied > 0 or NU < 64       # the aggregates' path ran
    p_end, _, n_sel, _ = serial[-1]

    out = Words(num_words)
    base = np.full(NB, p_end, np.int64)       # unused buckets: p_end
    pad = np.zeros(NB, np.int64)
    tbits = np.zeros(NB, np.int64)
    ent = np.stack([np.full(NSUB, -1), np.full(NSUB, PW.NO_POS),
                    np.full(NSUB, -1)]).astype(np.int64)
    wt = w.reshape(NU, THREADS, PER)
    ht = tok_h.reshape(NU, THREADS, PER)
    for u in range(NU):
        b, starts, eprev, hs, W = info[u]
        p, c, e, t = serial[u]
        ub = p
        if starts:
            bs = p + eprev
            pd = (5 - bs) & 7 if sto[b] else 0
            base[b], pad[b] = bs, pd
            ub = bs + hs + pd
            # the header row: 11 slots a lane, offsets by a warp scan
            wid = hdr_nbs[b, :PW.SLOT_EOB].copy()
            wid[PW.SLOT_PAD] = pd
            lane_sum = np.add.reduceat(wid, np.arange(0, PW.SLOT_EOB, H_LANE))
            lane_ex = np.cumsum(lane_sum) - lane_sum
            out.runs(bs + lane_ex, bs + lane_ex + lane_sum)
            offs = bs + np.cumsum(wid) - wid
            lo = hdr_lo[b, :PW.SLOT_EOB] & 0xFFFFFFFF
            or_bits(out.words, offs, lo & ((1 << np.minimum(wid, 32)) - 1),
                    wid)
            if b > 0:                       # the previous block's EOB
                out.runs(p, p + eprev)
                or_bits(out.words, np.array([p]),
                        np.array([hdr_lo[b - 1, PW.SLOT_EOB] & 0xFFFFFFFF
                                  & ((1 << min(eprev, 32)) - 1)]),
                        np.array([eprev]))
            if sto[b] and blen[b] > 0:
                n = min(int(blen[b]), TILE)
                byte0 = int(bs + 3 + pd + 32) >> 3
                g0, g1 = byte0 >> 2, (byte0 + n - 1) >> 2
                g = np.arange(g0, g1 + 1)
                out.touch(g, (g > g0) & (g < g1))
                by = np.zeros(4 * (g1 - g0 + 1), np.uint64)
                src = data[start[b] * TILE:start[b] * TILE + n]
                by[byte0 - 4 * g0:byte0 - 4 * g0 + n] = src
                x = np.bitwise_or.reduce(
                    by.reshape(-1, 4) << (np.arange(4, dtype=np.uint64) * 8),
                    1)
                ok = g < num_words
                np.bitwise_or.at(out.words, g[ok], x[ok])
        # the items' offsets: the CTA scan, then each thread's run
        t_sum = wt[u].sum(1)
        t_ex = np.cumsum(t_sum) - t_sum
        o = (ub + t_ex[:, None] + np.cumsum(wt[u], 1) - wt[u]).reshape(UNIT)
        q = u * UNIT + np.arange(UNIT)
        or_bits(out.words, o, v[q], w[q])
        tbits[b] += W
        if W > 0:   # the unit's window from bit 0, out shifted by ub mod 32
            win = Words(-(-W // 32) + 1)
            win.runs(t_ex, t_ex + t_sum)
            win.check()
            w0 = ub >> 5
            nout = ((ub & 31) + W + 31) >> 5
            i = np.arange(nout)
            out.touch(w0 + i, (i > 0) & (i < nout - 1))
        # the entries: each thread's first rank in closed form
        h_t = ht[u].sum(1)
        if h_t.sum() > 0:
            t0 = False if starts else t
            extra = not t0 and c % stride != 0
            hx = np.cumsum(h_t) - h_t
            c0 = c + hx
            r0 = (e + (-(-c0 // stride)) - mult_below(c, stride)
                  + (extra & (hx > 0)))
            cs = c0[:, None] + np.cumsum(ht[u], 1) - ht[u]
            sel = ht[u] & ((cs % stride == 0) | (extra & (cs == c)))
            rank = (r0[:, None] + np.cumsum(sel, 1) - sel)[sel]
            keep = rank < NSUB
            ent[:, rank[keep]] = np.stack([
                o.reshape(THREADS, PER)[sel], q.reshape(THREADS, PER)[sel],
                np.full(int(sel.sum()), b)])[:, keep]
    # the last unit: the last EOB, the tail
    b, _, _, _, W = info[-1]
    e0 = int(p_end - hdr_nbs[b, PW.SLOT_EOB])
    ew = int(hdr_nbs[b, PW.SLOT_EOB])
    out.runs(e0, e0 + ew)
    or_bits(out.words, np.array([e0]),
            np.array([hdr_lo[b, PW.SLOT_EOB] & 0xFFFFFFFF
                      & ((1 << min(ew, 32)) - 1)]), np.array([ew]))
    sf_pad = (5 - p_end) & 7
    total = p_end if final else p_end + 3 + sf_pad + 32
    if not final:
        t0 = int(p_end + 3 + sf_pad)
        out.runs(t0, t0 + 32)
        or_bits(out.words, np.array([t0]), np.array([0xFFFF0000]),
                np.array([32]))
    out.check()
    return {"words": out.words.astype(np.int64), "total_bits": total,
            "block_base": base, "pad": pad, "token_bits": tbits,
            "sub_bit": ent[0], "sub_out": ent[1], "sub_blk": ent[2],
            "sub_overflow": n_sel > NSUB}


def assert_model_matches_plain(args, final: bool, num_words: int):
    tens = [torch.as_tensor(a) for a in args]
    want = PW.pack_words_ref(*tens, final, num_words)
    got = pack_model(args, final, num_words)
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(got[field]),
                                      getattr(want, field).numpy(),
                                      err_msg=field)
    nw = -(-int(want.total_bits) // 32)
    assert not want.words[nw:].any()


SHARDS = {
    "text_final": ("text", 65536, 65536, True, {}),
    "random_stored": ("random", 65536, 65536, False, {}),
    "mixed_short": ("mixed", 262144, 200001, False, {}),
    "mixed_final": ("mixed", 262144, 262144, True, {}),
    "forced_stored": ("text", 131072, 100000, False, {"force_btype": 0}),
    "forced_fixed": ("mixed", 131072, 131072, True, {"force_btype": 1}),
    "one_tile": ("text", 32768, 20000, True, {}),
    "tiles32": ("mixed", 1 << 20, (1 << 20) - 777, False, {}),
    "tiles128": ("mixed", 4 << 20, 4 << 20, True, {}),
}


@pytest.mark.parametrize("name", list(SHARDS))
def test_pack_model_matches_plain_on_encoder_shards(name):
    kind, S, valid, final, kw = SHARDS[name]
    x = torch.from_numpy(corpus.sample(kind, S, seed=S % 977))
    got = corpus.block_stage_inputs(x, valid, final, **kw)
    _, _, a, k = got["pack_words"]
    assert not k
    assert a[-2] == final and a[-1] == td.out_words(S)
    assert_model_matches_plain([t.numpy() for t in a[:14]], final, a[-1])


@pytest.mark.parametrize("name", corpus.PACK_CASES)
def test_pack_model_matches_plain_on_synthetic_shards(name):
    *args, final, nw = corpus.pack_case(name)
    assert_model_matches_plain(args, final, nw)


def test_len_and_dist_fields_match_jax():
    """The closed forms the kernel computes in place of the token fields,
    against the JAX package's on every length and distance."""
    lens = np.arange(3, 259)
    dists = np.arange(1, 32769)
    for port, jax_fn, x in ((PW.len_fields, jd._len_fields, lens),
                            (PW.dist_fields, jd._dist_fields, dists)):
        got = [t.numpy() for t in port(torch.from_numpy(x))]
        want = [np.asarray(t) for t in jax_fn(x.astype(np.int32))]
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g, wv)


def test_pack_words_plain_does_not_change_its_inputs():
    *args, final, nw = corpus.pack_case("nb32")
    tens = [torch.as_tensor(a) for a in args]
    before = [t.clone() for t in tens]
    PW.pack_words(*tens, final, nw)
    for t, b in zip(tens, before):
        assert torch.equal(t, b)


def test_pack_words_wrapper_checks():
    *args, final, nw = corpus.pack_case("nb1")
    tens = [torch.as_tensor(a) for a in args]

    def call(i, x, num_words=nw):
        a = list(tens)
        a[i] = x
        return PW.pack_words(*a, final, num_words)
    with pytest.raises(ValueError):
        call(0, tens[0][:-1])                   # S not a multiple
    with pytest.raises(ValueError):
        call(2, tens[2].int())                  # length int32
    with pytest.raises(ValueError):
        call(9, tens[9][:, :286].contiguous())  # table without its column
    with pytest.raises(ValueError):
        call(11, torch.cat([tens[11], tens[11]], 1)[:, ::2])
    with pytest.raises(TypeError):
        call(4, tens[4].numpy())
    with pytest.raises(ValueError):
        call(0, tens[0], num_words=0)
    with pytest.raises(ValueError):
        call(1, tens[1].to("meta"))
