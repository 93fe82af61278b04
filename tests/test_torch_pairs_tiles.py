"""The order of work of pair_counts' tile kernel (csrc/pairs.cu), modelled
in numpy index for index and held to JAX's ops/pairs.py::_pairs_accum and
_pairs_batch, tolerance 0.

The model does what the kernel and its wrapper do: the wrapper sorts a
batch that is not sorted by start (a stable sort); the kernel walks the
tiles of TILE sites from the first fragment's first pair site to the last
one's last; warp 0 finds each tile's fragments [lo, hi), the start_rel in
[site0 - (L - 1), site0 + tile_n - 1), by the 33-ary search (modelled
probe for probe and held to np.searchsorted); a row's first min(L, ROW_MAX)
bytes are read with V-byte loads (V = 8, 4 or 1 by L and the codes'
alignment), and a row of at most ROW_MAX calls becomes the ok / C masks,
four calls a word as the zero-byte test and multiply give them, its
valid pairs in the tile ok & ok << 1 cut to the tile's positions; a
longer row (L > ROW_MAX only) is walked position by position; the adds go
to four uint32 planes; the flush adds each site with a count into the
int32 table. The model runs at the
kernel's TILE and at a small tile that puts many tile edges in a batch,
on sorted and unsorted slabs, start_rel < 0, rows past the window, L 24
and 200, tiles that no fragment reaches, tile edges hit exactly, and
counts up to 3000."""

import os.path as op
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from synth import random_frags  # noqa: E402
from wgbs_tools_tpu.ops import pairs as jpairs  # noqa: E402
from wgbs_tools_tpu_torch.formats.pat import PatFrags  # noqa: E402
from wgbs_tools_tpu_torch.ops import pairs  # noqa: E402

WARP = 32
CODE_C = 1
SRC = op.join(op.dirname(op.abspath(pairs.__file__)), "..", "csrc",
              "pairs.cu")


def warp_lower_bound(a, key):
    """csrc/pairs.cu::warp_lower_bound2 for one key: while the range is
    wider than a warp, 32 probes cut it into 33 parts and the first probe
    >= key narrows it; then one probe a lane. Returns (index, probes)."""
    lo, hi, probes = 0, len(a), 0
    lanes = np.arange(WARP, dtype=np.int64)
    while hi - lo > WARP:
        w = hi - lo
        ge = a[lo + (lanes + 1) * w // (WARP + 1)] >= key
        first = int(np.argmax(ge)) if ge.any() else WARP
        l0 = lo
        if first > 0:
            lo = l0 + first * w // (WARP + 1) + 1
        if first < WARP:
            hi = l0 + (first + 1) * w // (WARP + 1)
        probes += 1
    ge = a[lo:hi] >= key
    return (lo + int(np.argmax(ge)) if ge.any() else hi), probes + 1


def bit_range(lo, hi):
    """Bits [lo, hi) of a 32-bit mask (csrc/pairs.cu::bit_range)."""
    if lo >= hi:
        return 0
    return ((1 << hi) - 1) & ~((1 << lo) - 1)


U32 = 0xFFFFFFFF


def ok4(x):
    """csrc/pairs.cu::ok4 in uint32 arithmetic: bit j set where byte j of
    x is 0 or 1 (a zero-byte test of x & 0xFEFEFEFE, then a multiply)."""
    y = x & 0xFEFEFEFE
    z = ~((((y & 0x7F7F7F7F) + 0x7F7F7F7F) & U32) | y) & 0x80808080
    return ((z * 0x00204081) & U32) >> 28


def c4(x):
    """csrc/pairs.cu::c4: bit j = bit 0 of byte j of x."""
    return (((x & 0x01010101) * 0x01020408) & U32) >> 24


def row_words(row, V):
    """csrc/pairs.cu::load_frag's words of a row: its first Lr = min(L,
    ROW_MAX) bytes by V-byte loads that stay inside the row (the rest 0)."""
    row = bytes(row)
    L = len(row)
    Lr = min(L, pairs.ROW_MAX)
    got = bytearray(pairs.ROW_MAX)
    for j in range(pairs.ROW_MAX // V):
        if V * j < Lr:
            assert V * (j + 1) <= L  # V divides L: inside the row
            got[V * j:V * (j + 1)] = row[V * j:V * (j + 1)]
    return [int.from_bytes(got[q:q + 4], "little")
            for q in range(0, pairs.ROW_MAX, 4)]


def row_masks(words):
    """csrc/pairs.cu::frag_masks: ok (T or C) and c (bit 0: C where T or
    C) masks of the words, four calls a word."""
    ok = c = 0
    for k, x in enumerate(words):
        ok |= ok4(x) << (4 * k)
        c |= c4(x) << (4 * k)
    return ok, c


def vector_width(L, align):
    """The V that csrc/pairs.cu's entry picks for row width L and codes at
    an address == align (mod 16)."""
    for V in (8, 4):
        if L % V == 0 and align % V == 0:
            return V
    return 1


def pairs_tile_model(table, start_rel, length, count, codes, is_sorted=None,
                     tile=pairs.TILE, align=0):
    """table (n, 4) int32 += the batch's pair counts in the kernel's order
    of work (numpy arrays; `align`: the codes' address mod 16). Returns
    (table, stats)."""
    start_rel = np.asarray(start_rel, np.int64)
    length = np.asarray(length, np.int64)
    count = np.asarray(count, np.int64)
    table = np.array(table, np.int32)
    stats = {"tiles": 0, "empty_tiles": 0, "thread_rows": 0, "warp_rows": 0,
             "flushed_sites": 0, "probes": 0, "sorted_by_wrapper": False}
    n = table.shape[0]
    F, L = codes.shape
    if F == 0 or L < 2 or n == 0:
        return table, stats
    # the wrapper: is_sorted None checks, an unsorted batch is sorted
    if is_sorted is None:
        is_sorted = bool(np.all(start_rel[1:] >= start_rel[:-1]))
    if not is_sorted:
        order = np.argsort(start_rel, kind="stable")
        start_rel, length, count, codes = (start_rel[order], length[order],
                                           count[order], codes[order])
        stats["sorted_by_wrapper"] = True
    V = vector_width(L, align)
    tab = table.view(np.uint32).reshape(n, 4)
    num_tiles = -(-n // tile)
    first = int(start_rel[0]) + 1
    t_first = first // tile if first > 0 else 0
    end = int(start_rel[-1]) + L - 1
    t_last = -1 if end < 0 else min(end // tile, num_tiles - 1)
    for t in range(t_first, t_last + 1):
        site0 = t * tile
        tile_n = min(tile, n - site0)
        lo, p0 = warp_lower_bound(start_rel, site0 - (L - 1))
        hi, p1 = warp_lower_bound(start_rel, site0 + tile_n - 1)
        assert lo == np.searchsorted(start_rel, site0 - (L - 1))
        assert hi == np.searchsorted(start_rel, site0 + tile_n - 1)
        stats["tiles"] += 1
        stats["probes"] += max(p0, p1)
        stats["empty_tiles"] += hi <= lo
        planes = np.zeros((4, tile), np.uint32)
        for f in range(lo, hi):
            s0 = int(start_rel[f])
            last = min(int(length[f]), L)
            plo = max(site0 - s0, 1)
            phi = min(site0 + tile_n - s0, last)
            n_f = np.uint32(count[f] & 0xFFFFFFFF)
            if L <= pairs.ROW_MAX or length[f] <= pairs.ROW_MAX:
                stats["thread_rows"] += 1
                if plo >= phi:
                    continue
                ok, c = row_masks(row_words(codes[f], V))
                vm = ok & (ok << 1) & bit_range(plo, phi)
                assert vm <= U32  # positions < last <= ROW_MAX
                pre = (c << 1) & U32
                for cls in range(4):  # each class's pairs by __ffs
                    m = (vm & (pre if cls & 2 else ~pre)
                         & (c if cls & 1 else ~c))
                    while m:
                        p = (m & -m).bit_length() - 1
                        m &= m - 1
                        planes[cls, s0 + p - site0] += n_f
            else:
                stats["warp_rows"] += 1
                row = codes[f]
                for p in range(plo, phi):  # lane (p - plo) % 32
                    pre, cur = int(row[p - 1]), int(row[p])
                    if pre <= CODE_C and cur <= CODE_C:
                        planes[2 * pre + cur, s0 + p - site0] += n_f
        # the flush: a site whose four counts are zero is not touched
        nz = np.nonzero(planes[:, :tile_n].any(axis=0))[0]
        tab[site0 + nz] += planes[:, nz].T
        stats["flushed_sites"] += len(nz)
    return table, stats


def _cols(f, s):
    return ((f.start.astype(np.int64) - s).astype(np.int32),
            f.length.astype(np.int32), f.count.astype(np.int32), f.codes)


def _jax_batch(start, length, count, codes, n):
    return np.asarray(jpairs._pairs_batch(
        jnp.asarray(start), jnp.asarray(length), jnp.asarray(count),
        jnp.asarray(codes), n))


def _jax_accum(acc, start, length, count, codes):
    return np.asarray(jpairs._pairs_accum(
        jnp.asarray(acc), jnp.asarray(start), jnp.asarray(length),
        jnp.asarray(count), jnp.asarray(codes)))


def slab(case, seed=1):
    """(start_rel, length, count, codes, n) of a test case: fragments over
    a window of n sites."""
    rng = np.random.default_rng(seed)
    if case == "long_rows":  # L 200: rows up to 200 calls, a warp each
        f = random_frags(rng, 1500, 9000, max_len=200, max_count=3000,
                         h_rate=0.05, dot_rate=0.05)
        assert f.codes.shape[1] == 200
        return (*_cols(f, 1), 9000)
    f = random_frags(rng, 6000, 9000, max_len=24, max_count=3000,
                     h_rate=0.05, dot_rate=0.08)
    assert f.codes.shape[1] == 24
    start, length, count, codes = _cols(f, 1)
    n = 9000
    if case == "window":  # start_rel < 0 and rows past the window's end
        start, n = start - 3000, 4000
    elif case == "holes":  # no fragment reaches the sites [2100, 6200)
        keep = (start + 24 < 2100) | (start >= 6200)
        start, length, count, codes = (a[keep] for a in (start, length,
                                                         count, codes))
    elif case == "tile_edges":  # first pairs on a tile's first site, last
        # pairs on a tile's last site, for the kernel's tile and 64
        for k, site in enumerate((pairs.TILE, 2 * pairs.TILE, 64, 640)):
            start[k * 4:k * 4 + 2] = site - 1  # its first pair at `site`
            start[k * 4 + 2:k * 4 + 4] = site - length[k * 4 + 2:k * 4 + 4]
        order = np.argsort(start, kind="stable")
        start, length, count, codes = (a[order] for a in (start, length,
                                                          count, codes))
    elif case == "unsorted":
        p = rng.permutation(len(start))
        start, length, count, codes = (a[p] for a in (start, length, count,
                                                      codes))
    return start, length, count, codes, n


CASES = ("sorted", "unsorted", "window", "holes", "tile_edges", "long_rows")


def test_byte_tests_on_every_byte():
    """ok4 and c4 on every byte value at every position of a word: ok
    where the byte is T (0) or C (1), c the byte's bit 0 (C where ok), the
    other bytes of the word any value."""
    rng = np.random.default_rng(0)
    for b in range(256):
        for j in range(4):
            for other in rng.integers(0, 2**32, size=8).tolist():
                x = (other & ~(0xFF << (8 * j)) & U32) | (b << (8 * j))
                assert (ok4(x) >> j) & 1 == (b <= CODE_C)
                assert (c4(x) >> j) & 1 == b & 1


def test_search_equals_searchsorted():
    """The 33-ary search gives np.searchsorted's left index on sorted
    arrays with runs of equal starts, keys below, inside and above them."""
    rng = np.random.default_rng(0)
    for size in (1, 2, 31, 32, 33, 34, 1000, 1089, 200_000):
        a = np.sort(rng.integers(-50, 5000, size=size))
        for key in np.concatenate([[-1000, a[0], a[-1], a[-1] + 1, 10**6],
                                   rng.integers(-60, 5010, size=30)]):
            got, probes = warp_lower_bound(a, int(key))
            assert got == np.searchsorted(a, key, side="left")
            assert probes <= 6


@pytest.mark.parametrize("tile", [pairs.TILE, 64])
@pytest.mark.parametrize("case", CASES)
def test_model_equals_jax(case, tile):
    """The model on a zeroed table == _pairs_batch and, on a nonzero
    table, == _pairs_accum; every tile it walks is flushed once."""
    start, length, count, codes, n = slab(case)
    want = _jax_batch(start, length, count, codes, n)
    got, st = pairs_tile_model(np.zeros((n, 4), np.int32), start, length,
                               count, codes, tile=tile)
    assert np.array_equal(got, want)
    assert st["sorted_by_wrapper"] == (case == "unsorted")
    assert st["warp_rows"] > 0 if case == "long_rows" else (
        st["warp_rows"] == 0)
    assert st["flushed_sites"] == int((want != 0).any(axis=1).sum())
    if case == "holes" and tile == 64:
        assert st["empty_tiles"] > 0
    if case == "window":
        assert start.min() < 0 and start.max() + length.max() > n
    acc0 = np.random.default_rng(3).integers(-2**31, 2**31, (n, 4),
                                             dtype=np.int64).astype(np.int32)
    got, _ = pairs_tile_model(acc0, start, length, count, codes, tile=tile)
    assert np.array_equal(got, _jax_accum(acc0, start, length, count, codes))


@pytest.mark.parametrize("align", [0, 4, 1])
@pytest.mark.parametrize("L", [24, 20, 13])
def test_model_vector_widths_equal_jax(L, align):
    """V = 8, 4 or 1 (by L and the codes' address): the same table."""
    rng = np.random.default_rng(L + align)
    f = random_frags(rng, 3000, 5000, max_len=L, max_count=3000,
                     h_rate=0.1, dot_rate=0.1)
    assert f.codes.shape[1] == L
    start, length, count, codes = _cols(f, 1)
    got, _ = pairs_tile_model(np.zeros((5000, 4), np.int32), start, length,
                              count, codes, tile=512, align=align)
    assert np.array_equal(got, _jax_batch(start, length, count, codes,
                                          5000))


@pytest.mark.parametrize("name", chip_smoke.PAIR_EDGE)
def test_model_on_pair_edge_batches_equals_jax(name):
    """chip_smoke.py's pair_counts edge batches (unsorted, with H, '.',
    start_rel < 0, length 1, the window's last site; a sorted slab of rows
    up to 200 calls)."""
    start, length, count, codes, n = chip_smoke.pair_edge_batch(name)
    got, st = pairs_tile_model(np.zeros((n, 4), np.int32), start, length,
                               count, codes)
    assert np.array_equal(got, _jax_batch(start, length, count, codes, n))
    assert st["sorted_by_wrapper"] == (name == "unsorted")
    L = codes.shape[1]
    assert st["warp_rows"] > 0 and L > pairs.ROW_MAX  # rows of 33-L calls


def test_streaming_pairs_through_the_model_equals_jax(monkeypatch):
    """StreamingPairs with the kernel's order of work in place of the
    fold, over slabs of a sorted batch (is_sorted=True, as the main path
    passes it) == JAX's StreamingPairs."""
    calls = []

    def model_add(table, start_rel, length, count, codes, is_sorted=None):
        assert is_sorted is True
        got, _ = pairs_tile_model(table.numpy(), start_rel.numpy(),
                                  length.numpy(), count.numpy(),
                                  codes.numpy(), is_sorted)
        table.copy_(torch.from_numpy(got))
        calls.append(len(start_rel))
        return table

    monkeypatch.setattr(pairs, "pair_counts_add", model_add)
    f = random_frags(np.random.default_rng(9), 5000, 7000, max_len=24,
                     max_count=3000, h_rate=0.05)
    frags = PatFrags(f.start, f.length, f.count, f.codes, f.chrom_id,
                     f.chrom_names)
    window = (300, 6500)
    sp = pairs.StreamingPairs(window, device="cpu")
    jsp = jpairs.StreamingPairs(window)
    for lo in range(0, 5000, 1300):
        part = frags.take(slice(lo, lo + 1300))
        sp.add(part)
        jsp.add(part)
    assert len(calls) == 4
    assert np.array_equal(sp.result(), jsp.result())


def test_geometry_equals_the_kernel_source():
    """ops/pairs.py's TILE and ROW_MAX are csrc/pairs.cu's."""
    with open(SRC) as f:
        src = f.read()
    for name in ("TILE", "ROW_MAX"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(pairs, name), name
