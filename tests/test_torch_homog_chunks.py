"""The order of work of homog_bins' chunk kernel (csrc/homog.cu), modelled
in numpy index for index and held to JAX's ops/frag_ops.py::homog_counts
(the numpy backend) and _homog_counts_jax (backend="jax", on the CPU),
tolerance 0; past 2^31 to the numpy backend alone (JAX's device path sums
in int32 there).

The model does what the kernel does: chunks of CHUNK pairs a warp; the
window of (block, bin) cells from the least block of the chunk's first
32 pairs on, a pair whose cell falls outside it added straight into out;
each row read as the 8-byte aligned words from its address rounded down,
from a memory image where the codes lie at a given byte offset mod 16
among random bytes: the first PREFETCH_WORDS words that hold a byte of
the row, then the clip's words past them, the T and C-or-H flags of each
word by the SWAR tests and the gathering multiply, counted under the
clip's bit range; the bin by a linear count of the edges (nbins <=
LINEAR_BINS) or a binary search; the window's sums of the low and the
high 16 bits of the counts; the flush of each nonzero cell up to the
last one added to as one global atomic. It counts the kernel's stats
(chunks, pairs added straight into out, passing pairs, global atomics),
the pairs whose clip reaches past the prefetched words and the cells two
chunks flush. Cases: pairs sorted and permuted; non-nice, overlapping
blocks with one over the whole range; chunk edges that split a block's
pairs; L 24, 60 and 200 at every byte offset mod 16 of the codes; the
main path's rows widened to 25, 41 and 72 calls (chip_smoke.py's row
forms); bytes above 3; clips that start or end mid-word; meth ties on
every edge; inclusive; min_cpgs 1, 3 and 4; 100 bins; counts past 2^32;
chip_smoke.py's HOMOG_EDGE batches."""

import os.path as op
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from wgbs_tools_tpu.ops import frag_ops as jfo  # noqa: E402
from wgbs_tools_tpu_torch.formats.pat import PatFrags  # noqa: E402
from wgbs_tools_tpu_torch.ops import frag_ops  # noqa: E402
from wgbs_tools_tpu_torch.pipeline.pat_stream import (  # noqa: E402
    homog_pat_streaming)

WARP = 32
SRC = op.join(op.dirname(op.abspath(frag_ops.__file__)), "..", "csrc",
              "homog.cu")
U32 = np.uint32
U64 = np.uint64
RANGES = {"rlen3": [0.0, 0.334, 0.667, 1.0], "ties": [0.0, 0.25, 0.5, 1.0],
          "hundred": [k / 100 for k in range(101)]}


def call_flags(x):
    """csrc/homog.cu::call_flags on uint64 arrays: (T flags, C-or-H
    flags), bit j for byte j, by the SWAR tests and the gathering
    multiply."""
    x = np.asarray(x, np.uint64)
    small = ~(((x & U64(0x7C7C7C7C7C7C7C7C)) + U64(0x7F7F7F7F7F7F7F7F)) | x) \
        & U64(0x8080808080808080)
    b0, b1 = x << U64(7), x << U64(6)
    gather = U64(0x0002040810204081)
    t = ((small & ~(b0 | b1)) * gather) >> U64(56)
    ch = ((small & (b0 ^ b1)) * gather) >> U64(56)
    return t.astype(U32), ch.astype(U32)


def bit_range(lo, hi):
    """Bits [lo, hi) as a uint32 mask, 0 <= lo <= hi <= 32."""
    lo = np.asarray(lo, np.uint64)
    hi = np.asarray(hi, np.uint64)
    return (((U64(1) << hi) - U64(1)) & ~((U64(1) << lo) - U64(1))).astype(
        U32)


def bins_of(meth, edges, nbins):
    """csrc/homog.cu::bin_of: a linear count of the edges <= meth for
    nbins <= LINEAR_BINS, else a binary search; minus 1, capped."""
    edges = np.asarray(edges, np.float32)
    if nbins <= frag_ops.LINEAR_BINS:
        le = (edges[None, :] <= meth[:, None]).sum(axis=1)
    else:
        le = np.zeros(meth.shape[0], np.int64)
        hi = np.full(meth.shape[0], nbins + 1, np.int64)
        while (le < hi).any():
            act = le < hi
            mid = (le + hi) // 2
            go = edges[np.minimum(mid, nbins)] <= meth
            le = np.where(act & go, mid + 1, le)
            hi = np.where(act & ~go, mid, hi)
    return np.minimum(le - 1, nbins - 1)


def homog_chunk_model(out, codes, fstart, flen, fcount, bstart, bend, fi,
                      bi, ranges, min_cpgs, inclusive, align=0, seed=0):
    """out (B, nbins) int64 += the kernel's counts, by its order of work,
    with the codes at byte `align` (mod 16) of a memory image. Returns
    (out, stats)."""
    rng = np.random.default_rng(seed)
    F, L = codes.shape
    P = fi.shape[0]
    nbins = len(ranges) - 1
    edges = np.asarray(ranges, np.float32)
    # the memory image: random bytes around the codes, 8-byte words
    mem = rng.integers(0, 256, size=align + F * L + 64, dtype=np.uint8)
    mem[align:align + F * L] = codes.ravel()
    mem = np.concatenate([mem, np.zeros(-mem.size % 8, np.uint8)])
    mem64 = mem.view("<u8")
    # the prefetched words that can hold a row's bytes, as the launch
    # counts them
    pf = frag_ops.PREFETCH_WORDS
    npf = min(pf, ((align % 8 if L % 8 == 0 else 7) + L + 7) // 8)
    win_lo = np.zeros(frag_ops.WINDOW_CELLS, np.int64)
    win_hi = np.zeros(frag_ops.WINDOW_CELLS, np.int64)
    flat = out.reshape(-1)
    st = {"chunks": 0, "direct": 0, "passing": 0, "atomics": 0, "past": 0}
    flushed = {}  # cell -> chunks that flushed it
    for c in range((P + frag_ops.CHUNK - 1) // frag_ops.CHUNK):
        q = np.arange(c * frag_ops.CHUNK, min(P, (c + 1) * frag_ops.CHUNK))
        f = fi[q].astype(np.int64)
        b = bi[q].astype(np.int64)
        b0 = int(b[:WARP].min())  # the window: from its first lanes' least
        st["chunks"] += 1
        # each pair's clip [c0, c1) within its row, and its length gate
        s = fstart[f].astype(np.int64)
        ln = flen[f].astype(np.int64)
        cnt = fcount[f].astype(np.int64)
        if inclusive:
            length, c0 = ln, np.zeros_like(s)
        else:
            os_ = np.maximum(s, bstart[b])
            length = np.minimum(s + ln, bend[b]) - os_
            c0 = np.minimum(os_ - s, L)
        ok = length >= min_cpgs
        c1 = np.minimum(c0 + length, L)
        have = ok & (c1 > c0)
        # the row's aligned words from its address rounded down: the first
        # npf that hold a byte of it, with the pair
        row = align + f * L
        r = row & 7
        base = (row - r) // 8
        t = np.zeros(len(q), U32)
        ch = np.zeros(len(q), U32)
        for w in range(npf):
            held = 8 * w < r + L
            x = np.where(held, mem64[np.where(held, base + w, 0)], U64(0))
            tw, cw = call_flags(x)
            t |= tw << U32(8 * w)
            ch |= cw << U32(8 * w)
        lo, hi = r + c0, r + c1
        pre = have & (lo < 8 * pf)
        m = np.where(pre, bit_range(np.where(pre, lo, 0),
                                    np.where(pre, np.minimum(hi, 8 * pf),
                                             0)), U32(0))
        nrT = np.bitwise_count(t & m).astype(np.int64)
        nrC = np.bitwise_count(ch & m).astype(np.int64)
        # the clip's words past the prefetched ones, one at a time
        past = have & (hi > 8 * pf)
        st["past"] += int(past.sum())
        w = np.maximum(lo // 8, pf)
        while (act := past & (8 * w < hi)).any():
            assert (8 * w < r + L)[act].all()  # a word holding a row byte
            tw, cw = call_flags(mem64[np.where(act, base + w, 0)])
            mw = bit_range(np.clip(lo - 8 * w, 0, 8),
                           np.clip(hi - 8 * w, 0, 8))
            nrT += np.where(act, np.bitwise_count(tw & mw), 0)
            nrC += np.where(act, np.bitwise_count(cw & mw), 0)
            w += 1
        informative = nrC + nrT
        ok &= (informative >= min_cpgs) & (informative > 0)
        meth = (nrC.astype(np.float32)
                / np.maximum(informative, 1).astype(np.float32))
        bins = bins_of(meth, edges, nbins)
        ok &= bins >= 0
        st["passing"] += int(ok.sum())
        # the window holds WINDOW_CELLS // nbins blocks from b0
        cell = (b - b0) * nbins + bins
        inwin = ok & (b >= b0) & (b - b0 < frag_ops.WINDOW_CELLS // nbins)
        direct = ok & ~inwin
        # the window's two 32-bit sums: each below 2^24 (a chunk's counts)
        np.add.at(win_lo, cell[inwin], cnt[inwin] & 0xFFFF)
        np.add.at(win_hi, cell[inwin], cnt[inwin] >> 16)
        assert np.abs(win_lo).max() < 2**24 and np.abs(win_hi).max() < 2**24
        np.add.at(flat, b[direct] * nbins + bins[direct], cnt[direct])
        st["direct"] += int(direct.sum())
        st["atomics"] += int(direct.sum())
        # the flush of the cells up to the last one added to
        top_cell = int(cell[inwin].max()) + 1 if inwin.any() else 0
        v = win_hi[:top_cell] * 65536 + win_lo[:top_cell]
        nz = np.nonzero(v)[0]
        np.add.at(flat, b0 * nbins + nz, v[nz])
        st["atomics"] += nz.shape[0]
        for k in (b0 * nbins + nz).tolist():
            flushed.setdefault(k, []).append(c)
        win_lo[:top_cell] = 0
        win_hi[:top_cell] = 0
    assert not win_lo.any() and not win_hi.any()
    st["shared_cells"] = sum(len(v) > 1 for v in flushed.values())
    return out, st


def model_counts(frags, bstart, bend, ranges, min_cpgs, inclusive, fi=None,
                 bi=None, align=0):
    """homog_counts through the model (the pairs from overlap_pairs unless
    given)."""
    if fi is None:
        fi, bi = frag_ops.overlap_pairs(frags, bstart, bend)
    out = np.zeros((len(bstart), len(ranges) - 1), np.int64)
    return homog_chunk_model(
        out, frags.codes, frags.start.astype(np.int32),
        frags.length.astype(np.int32), frags.count.astype(np.int32),
        np.asarray(bstart, np.int64), np.asarray(bend, np.int64), fi, bi,
        ranges, min_cpgs, inclusive, align=align)


def _want(frags, bstart, bend, ranges, m, inclusive, jax=True):
    want = jfo.homog_counts(frags, bstart, bend, ranges, min_cpgs=m,
                            inclusive=inclusive)
    if jax:
        assert np.array_equal(want, jfo.homog_counts(
            frags, bstart, bend, ranges, min_cpgs=m, inclusive=inclusive,
            backend="jax"))
    return want


def make_case(seed, n_frags, L, block_len, n_sites=None, max_count=3000):
    """Reads sorted by start of 1-L sites (T / C / H / '.', '.' past the
    length) over blocks tiling the sites, block_len = (min, max) sites."""
    rng = np.random.default_rng(seed)
    n = n_sites or n_frags * 2
    start = np.sort(rng.integers(1, n, size=n_frags)).astype(np.int32)
    length = rng.integers(1, L + 1, size=n_frags).astype(np.int32)
    codes = rng.choice(np.array([0, 1, 2, 3], np.uint8), size=(n_frags, L),
                       p=[0.4, 0.35, 0.1, 0.15])
    codes[np.arange(L)[None, :] >= length[:, None]] = 3
    count = rng.integers(1, max_count + 1, size=n_frags).astype(np.int32)
    lo, hi = block_len
    bend = np.cumsum(rng.integers(lo, hi + 1, size=n // lo + 2)) + 1
    bstart = np.concatenate([[1], bend[:-1]])
    keep = bstart < n + L
    frags = PatFrags(start, length, count, codes,
                     np.zeros(n_frags, np.int16), ["chr1"])
    return frags, bstart[keep].astype(np.int64), bend[keep].astype(np.int64)


def non_nice(bstart, bend, n):
    """Every 7th block doubled half a block on, and one block over the
    whole range first: sorted by start, overlapping, ends not sorted."""
    idx = np.arange(0, bstart.shape[0], 7)
    shift = (bend[idx] - bstart[idx]) // 2 + 1
    s = np.concatenate([[1], np.insert(bstart, idx + 1, bstart[idx] + shift)])
    e = np.concatenate([[n], np.insert(bend, idx + 1, bend[idx] + shift)])
    return s, e


def test_byte_tests_on_every_byte():
    """call_flags on every byte value at every position of an 8-byte word,
    the other bytes any value: T where the byte is 0, C or H where it is 1
    or 2, neither for any other byte."""
    rng = np.random.default_rng(0)
    other = rng.integers(0, 2**63, size=64, dtype=np.uint64) * U64(2) + \
        rng.integers(0, 2, size=64, dtype=np.uint64)
    for j in range(8):
        keep = ~U64(0xFF << (8 * j))
        for byte in range(256):
            t, ch = call_flags((other & keep) | U64(byte << (8 * j)))
            assert ((t >> U32(j)) & U32(1) == (byte == 0)).all()
            assert ((ch >> U32(j)) & U32(1) == (byte in (1, 2))).all()
            assert ((t | ch) < 256).all()


def test_byte_masks_and_bins():
    """bit_range on every [lo, hi) of 32 bits; the binary search == the
    linear count == searchsorted(side="right") - 1 capped, on every edge
    of 100 bins and around it, meth 0 and 1."""
    for lo in range(33):
        for hi in range(lo, 33):
            want = sum(1 << k for k in range(lo, hi))
            assert int(bit_range(lo, hi)) == want
    edges = np.asarray(RANGES["hundred"], np.float32)
    meth = np.concatenate([edges, np.nextafter(edges, np.float32(-1)),
                           np.nextafter(edges, np.float32(2)),
                           np.float32([0.0, 1.0, 0.5])]).astype(np.float32)
    meth = meth[(meth >= 0) & (meth <= 1)]
    want = np.minimum(np.searchsorted(edges, meth, side="right") - 1, 99)
    assert np.array_equal(bins_of(meth, edges, 100), want)
    lin = (edges[None, :] <= meth[:, None]).sum(axis=1) - 1
    assert np.array_equal(np.minimum(lin, 99), want)


CASES = {
    # name: (seed, frags, L, block lengths, sites)
    "sorted": (1, 6000, 24, (10, 40), None),
    "permuted": (2, 6000, 24, (10, 40), None),
    "non_nice": (3, 4000, 24, (10, 40), None),
    "small_blocks": (4, 3000, 24, (1, 6), None),
    "hot_region": (5, 4000, 24, (200, 400), 2000),
    "high_bytes": (6, 4000, 24, (10, 40), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_equals_jax(case):
    """The model == JAX's numpy and jax backends, with the stats each
    case's shape implies: sorted pairs all through the window, one global
    atomic a (chunk, cell), a block's cells flushed by two chunks (a chunk
    edge splits its pairs); shuffled pairs or a block over the whole range
    partly straight into out; rows with bytes above 3 counted word by
    word."""
    seed, n, L, blen, sites = CASES[case]
    frags, bstart, bend = make_case(seed, n, L, blen, sites)
    if case == "non_nice":
        bstart, bend = non_nice(bstart, bend, 2 * n + L)
    if case == "high_bytes":  # bytes above 3 (neither T nor C or H)
        rng = np.random.default_rng(seed)
        hit = rng.random(frags.codes.shape) < 0.03
        frags.codes[hit] = rng.integers(4, 256, size=int(hit.sum()))
    fi, bi = frag_ops.overlap_pairs(frags, bstart, bend)
    if case == "permuted":
        perm = np.random.default_rng(seed).permutation(fi.shape[0])
        fi, bi = fi[perm], bi[perm]
    want = _want(frags, bstart, bend, RANGES["rlen3"], 3, False)
    got, st = model_counts(frags, bstart, bend, RANGES["rlen3"], 3, False,
                           fi, bi)
    assert want.sum() > 0 and np.array_equal(got, want)
    assert st["chunks"] == -(-fi.shape[0] // frag_ops.CHUNK) >= 3
    cells = frag_ops.homog_cells_plain(*_cols(frags, bstart, bend, fi, bi,
                                              "rlen3"), 3, False).numpy()
    assert st["passing"] == (cells >= 0).sum()
    if case in ("sorted", "small_blocks", "hot_region", "high_bytes"):
        assert st["direct"] == 0 and st["shared_cells"] > 0
        # one global atomic a (chunk, cell) touched
        chunk = np.arange(cells.shape[0]) // frag_ops.CHUNK
        assert st["atomics"] == np.unique(np.stack(
            [chunk[cells >= 0], cells[cells >= 0]]), axis=1).shape[1] \
            < st["passing"]
    else:
        assert st["direct"] > 0
    assert st["past"] == 0  # 24 calls: every clip within the prefetch


def _cols(frags, bstart, bend, fi, bi, ranges):
    """homog_cells_plain's tensors on the CPU (codes ... bi, ranges)."""
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        frags.codes, frags.start.astype(np.int32),
        frags.length.astype(np.int32), np.asarray(bstart, np.int64),
        np.asarray(bend, np.int64), fi.astype(np.int32), bi.astype(np.int32),
        np.asarray(RANGES[ranges], np.float32))]


@pytest.mark.parametrize("align", range(16))
@pytest.mark.parametrize("L", [24, 60, 200])
def test_model_at_every_row_offset_equals_jax(L, align):
    """The codes at every byte offset mod 16, rows of L bytes (clips
    starting and ending mid-word, rows across word edges at odd offsets),
    over short and long blocks: at L 24 every clip within the prefetched
    words, at L 60 and 200 some past them."""
    for blen in ((1, 6), (30, 90)):
        frags, bstart, bend = make_case(L + align, 2000 if L < 200 else 700,
                                        L, blen)
        want = _want(frags, bstart, bend, RANGES["rlen3"], 3, False,
                     jax=align % 8 == 0)
        got, st = model_counts(frags, bstart, bend, RANGES["rlen3"], 3,
                               False, align=align)
        assert want.sum() > 0 and np.array_equal(got, want)
        assert (st["past"] > 0) == (L > 24)


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("min_cpgs", [1, 3, 4])
@pytest.mark.parametrize("ranges", ["ties", "hundred"])
def test_model_ties_gates_and_bins_equal_jax(ranges, min_cpgs, inclusive):
    """Reads of 4 and 100 calls whose meth ties the edges 0.25 and 0.5
    and many of the 100 bins' edges exactly, meth 0 and 1, the min_cpgs
    gates, inclusive: the linear count (3 bins) and the binary search
    (100 bins), on the window (hot region) and the direct path."""
    rng = np.random.default_rng(min_cpgs)
    frags, bstart, bend = make_case(7, 3000, 100, (1, 8), 1500)
    codes = frags.codes
    n4 = codes.shape[0] // 2
    codes[:n4, 4:] = 3  # 4 calls of T / C / H: meth 0, .25, .5, .75, 1
    codes[:n4, :4] = rng.integers(0, 3, size=(n4, 4))
    frags.length[:n4] = 4
    # 100 calls, k of them C: meth k / 100
    k = rng.integers(0, 101, size=codes.shape[0] - n4)
    codes[n4:] = np.where(np.arange(100)[None, :] < k[:, None], 1, 0)
    frags.length[n4:] = 100
    want = _want(frags, bstart, bend, RANGES[ranges], min_cpgs, inclusive)
    got, st = model_counts(frags, bstart, bend, RANGES[ranges], min_cpgs,
                           inclusive)
    assert want.sum() > 0 and np.array_equal(got, want)
    if ranges == "hundred":
        assert st["direct"] > 0
    edges = np.asarray(RANGES[ranges], np.float32)
    meth = k.astype(np.float32) / np.float32(100)
    assert np.isin(meth, edges).sum() > 10  # exact ties on edges


def test_model_past_2_32_equals_numpy():
    """Counts near 2^31 - 1 into few cells: one chunk's window cell
    passes 2^32 and the counts add exactly in int64, as numpy's backend
    does; JAX's device path sums in int32 and wraps (ROADMAP §3)."""
    frags, bstart, bend = make_case(9, 3000, 24, (200, 400), 1000)
    frags.count[:] = (2**31 - 1 - np.random.default_rng(9).integers(
        0, 3001, size=3000)).astype(np.int32)
    want = jfo.homog_counts(frags, bstart, bend, RANGES["rlen3"],
                            min_cpgs=3)
    got, st = model_counts(frags, bstart, bend, RANGES["rlen3"], 3, False)
    assert np.array_equal(got, want) and want.max() > 2**32 * 50
    assert st["direct"] == 0
    wrapped = jfo.homog_counts(frags, bstart, bend, RANGES["rlen3"],
                               min_cpgs=3, backend="jax")
    assert not np.array_equal(wrapped, want)


@pytest.mark.parametrize("k", chip_smoke.HOMOG_ROW_FORMS)
def test_model_on_row_forms_equals_jax(k):
    """chip_smoke.homog_row_form (k '.' calls before each row, each
    fragment k sites earlier and longer, the same pairs): the twin and the
    model on rows of 24 + k calls == JAX's counts on the rows of 24, with
    clips past the prefetched words from k 17 on."""
    frags, bstart, bend = make_case(12, 4000, 24, (10, 40))
    fi, bi = frag_ops.overlap_pairs(frags, bstart, bend)
    want = _want(frags, bstart, bend, RANGES["rlen3"], 3, False)
    cols = chip_smoke.homog_row_form(chip_smoke._homog_cols(
        frags, bstart, bend, RANGES["rlen3"], "cpu", (fi, bi)), k)
    assert cols[0].shape[1] == 24 + k
    out = torch.zeros(want.shape, dtype=torch.int64)
    assert np.array_equal(frag_ops.homog_bins_plain(
        out.clone(), *cols, 3, False).numpy(), want)
    got, st = homog_chunk_model(out.numpy(), *(c.numpy() for c in cols), 3,
                                False)
    assert want.sum() > 0 and np.array_equal(got, want)
    assert (st["past"] > 0) == (k >= 17)


@pytest.mark.parametrize("name", chip_smoke.HOMOG_EDGE)
def test_model_on_homog_edge_batches_equals_jax(name):
    """chip_smoke.py's HOMOG_EDGE batches through the model, with the
    pairs the smoke hands the kernel (shuffled for permuted_pairs) == JAX's
    numpy backend; the stats each shape implies."""
    frags, bstart, bend, ranges, m, inclusive = chip_smoke.homog_edge_batch(
        name)
    fi, bi = chip_smoke.homog_edge_pairs(name, frags, bstart, bend)
    want = jfo.homog_counts(frags, bstart, bend, ranges, min_cpgs=m,
                            inclusive=inclusive)
    got, st = model_counts(frags, bstart, bend, ranges, m, inclusive, fi, bi)
    assert want.sum() > 0 and np.array_equal(got, want)
    assert (st["direct"] > 0) == (name in chip_smoke.HOMOG_DIRECT)
    if name in ("mask_rows", "long_rows"):
        assert st["past"] > 0
    if name == "big_counts":
        assert want.max() > 2**32


def test_streaming_homog_through_the_model_equals_jax(tmp_path,
                                                      monkeypatch):
    """homog_pat_streaming with the kernel's order of work in place of the
    twin, over tiny slabs == JAX's streaming homog."""
    from wgbs_tools_tpu.formats.pat import frags_to_bytes
    from wgbs_tools_tpu.pipeline.pat_stream import (
        homog_pat_streaming as jax_streaming)

    calls = []

    def model_bins(out, codes, fstart, flen, fcount, bstart, bend, fi, bi,
                   ranges, min_cpgs, inclusive):
        got, _ = homog_chunk_model(
            out.numpy(), codes.numpy(), fstart.numpy(), flen.numpy(),
            fcount.numpy(), bstart.numpy(), bend.numpy(), fi.numpy(),
            bi.numpy(), ranges.numpy(), min_cpgs, inclusive)
        out.copy_(torch.from_numpy(got))
        calls.append(fi.shape[0])
        return out

    monkeypatch.setattr(frag_ops, "homog_bins", model_bins)
    frags, bstart, bend = make_case(11, 4000, 24, (5, 30))
    pat = tmp_path / "p.pat"
    pat.write_bytes(frags_to_bytes(frags))
    want = jax_streaming(str(pat), bstart, bend, RANGES["rlen3"], min_len=3,
                         chunk_bytes=20000)
    got = homog_pat_streaming(str(pat), bstart, bend, RANGES["rlen3"],
                              min_len=3, chunk_bytes=20000, device="cpu")
    assert len(calls) > 3 and want.sum() > 0 and np.array_equal(got, want)


def test_geometry_equals_the_kernel_source():
    """ops/frag_ops.py's CHUNK (WARP x PER), WINDOW_CELLS, EDGES_MAX,
    LINEAR_BINS, TABLE_CALLS and PREFETCH_WORDS are csrc/homog.cu's."""
    with open(SRC) as f:
        src = f.read()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert "constexpr int CHUNK = WARP * PER;" in src
    assert frag_ops.CHUNK == const("WARP") * const("PER") == WARP * const(
        "PER")
    for name in ("WINDOW_CELLS", "EDGES_MAX", "LINEAR_BINS", "TABLE_CALLS",
                 "PREFETCH_WORDS"):
        assert const(name) == getattr(frag_ops, name), name
