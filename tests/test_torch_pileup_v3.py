"""The v3 kernels' plain twins equal the JAX package's Pallas kernels
(interpret mode) on identical staged inputs, with tolerance 0, in every
staged form (value planes, lane counts, classic) and on both grids (flat,
tiled); the CUDA kernels equal their twins on the card, and leave the
caller's current device as it was."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.ops import pileup_tpu3 as jax_v3  # noqa: E402
from wgbs_tools_tpu.ops.pileup import pileup_xla  # noqa: E402
from wgbs_tools_tpu_torch.ops import pileup_v3  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native packer unavailable")

SMALL = dict(tile=512, rc=64, g_max=4)

# (random_frags kwargs, window_start, window_len, geometry, form)
CASES = {
    "vals_dense": (dict(nr_frags=2500, nr_sites=5000, max_len=18,
                        dot_rate=0.05, h_rate=0.05), 1, 5000, SMALL, "vals"),
    "vals_empty_tiles": (dict(nr_frags=40, nr_sites=30000, max_len=10),
                         1, 30000, SMALL, "vals"),
    "vals_left_edge": (dict(nr_frags=2000, nr_sites=6000, max_len=16),
                       2500, 2048, SMALL, "vals"),
    "vals_long_frags": (dict(nr_frags=300, nr_sites=9000, max_len=400),
                        1, 9000, SMALL, "vals"),
    "classic_counts_3000": (dict(nr_frags=300, nr_sites=4000, max_len=10,
                                 max_count=3000, dot_rate=0.1, h_rate=0.05),
                            1, 4000, SMALL, "classic"),
    "classic_empty_tiles_left_edge": (dict(nr_frags=60, nr_sites=20000,
                                           max_len=150, max_count=3000),
                                      700, 15000, SMALL, "classic"),
    # the lane-count form (TPU kernel 5): stage_v3(vals=False)
    "lane_dense": (dict(nr_frags=2500, nr_sites=5000, max_len=18,
                        dot_rate=0.05, h_rate=0.05, max_count=120), 1, 5000,
                   dict(SMALL, vals=False), "lane"),
    "lane_empty_tiles": (dict(nr_frags=40, nr_sites=30000, max_len=10),
                         1, 30000, dict(SMALL, vals=False), "lane"),
    "lane_left_edge": (dict(nr_frags=2000, nr_sites=6000, max_len=16),
                       2500, 2048, dict(SMALL, vals=False), "lane"),
    "lane_long_frags": (dict(nr_frags=300, nr_sites=9000, max_len=400),
                        1, 9000, dict(SMALL, vals=False), "lane"),
}

KERNELS = {"vals": (pileup_v3.flat_vals_fused,
                    pileup_v3.flat_vals_fused_plain),
           "lane": (pileup_v3.flat_lc, pileup_v3.flat_lc_plain),
           "classic": (pileup_v3.flat_classic, pileup_v3.flat_classic_plain)}


def _case(name):
    kw, ws, wl, geo, form = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 101)
    return random_frags(rng, **kw), ws, wl, geo, form


def _jax_pileup(staged, wl, grid="flat"):
    """JAX call_staged (Pallas, interpret mode) summed over rc classes."""
    out = np.zeros((wl, 2), np.int64)
    for st in staged if isinstance(staged, list) else [staged]:
        m, c = jax_v3.call_staged(st, wl, interpret=True, grid=grid)
        out += np.stack([np.asarray(m), np.asarray(c)], axis=1)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_equals_jax_kernel(name):
    f, ws, wl, geo, form = _case(name)
    staged = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                             **geo)
    port = pileup_v3.staged_from_numpy(staged, "cpu")
    for st in port if isinstance(port, list) else [port]:
        assert st.form == form
    got = pileup_v3.call_staged(port, wl)
    assert got.dtype == torch.int32 and tuple(got.shape) == (wl, 2)
    want = _jax_pileup(staged, wl)
    assert np.array_equal(got.numpy(), want)
    # and both equal the scatter oracle
    assert np.array_equal(want, pileup_xla(f.start, f.length, f.count,
                                           f.codes, ws, wl))
    if name.endswith("empty_tiles"):
        one = staged[0] if isinstance(staged, list) else staged
        assert ((one[1] - one[0]) == 0).any()


def test_pileup_v3_equals_jax_default_geometry():
    """End to end at the default geometry (rc=1024, tile_sb=64): the port's
    staging + twin against pileup_pallas_v3 in interpret mode."""
    f = random_frags(np.random.default_rng(7), 3000, 20000, max_len=24)
    want = jax_v3.pileup_pallas_v3(f.start, f.length, f.count, f.codes, 1,
                                   20000, interpret=True)
    got = pileup_v3.pileup_v3(f.start, f.length, f.count, f.codes, 1, 20000,
                              "cpu")
    assert np.array_equal(got.numpy(), want)


def test_staged_from_numpy_rejects_unported_forms():
    """Every form the JAX package stages is ported now: split value planes
    and the lane-count form (9 fields, TPU kernel 5) are accepted. Only
    malformed tuples are rejected: a wrong field count, a bad tag, chunk
    ranges out of bounds, a max_chunks below a tile's chunks."""
    f = random_frags(np.random.default_rng(8), 200, 3000)
    split = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                            fused=False, **SMALL)
    st = pileup_v3.staged_from_numpy(split, "cpu")
    assert st.form == "vals_split" and st.cv is not None
    assert tuple(st.rows.shape) == tuple(st.cv.shape) == split[3].shape
    lane = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                           vals=False, **SMALL)
    for one, st in zip(lane, pileup_v3.staged_from_numpy(lane, "cpu")):
        assert len(one) == 9 and st.form == "lane" and st.cv is None
        assert np.array_equal(st.cnts.numpy(), one[4])
        assert st.max_chunks == one[5]
    good = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                           **SMALL)
    for bad, match in ((lane[0][:7], "7 fields"), (good + (0,), "11 fields"),
                       (good[:9] + ("planes",), "tagged 'planes'")):
        with pytest.raises(ValueError, match=match):
            pileup_v3.staged_from_numpy(bad, "cpu")
    # lane-count words of the wrong width never reach the kernel
    bad = list(lane[0])
    bad[4] = bad[4][:, :16]
    with pytest.raises(ValueError, match="staged cnts"):
        pileup_v3.call_staged(pileup_v3.staged_from_numpy(tuple(bad), "cpu"),
                              3000)
    bad = list(good)
    bad[1] = bad[1] + 10**6  # c1 past the chunk count
    with pytest.raises(ValueError, match="out of bounds"):
        pileup_v3.staged_from_numpy(tuple(bad), "cpu")
    bad = list(lane[0])
    bad[5] = 0
    with pytest.raises(ValueError, match="max_chunks"):
        pileup_v3.staged_from_numpy(tuple(bad), "cpu")


TILED_CASES = sorted(n for n in CASES if CASES[n][4] != "lane")


def _tiled_case(name):
    """A case staged as the tiled grid stages it (lane_counts=False, so the
    classic form at every count); "sparse" is test_pileup_tpu3.py's
    mostly-empty window at the default geometry in one rc class, "empty"
    the batch with no fragment."""
    if name == "sparse":
        f = random_frags(np.random.default_rng(12), 60, 50000, max_len=10)
        ws, wl, geo = 1, int(f.start.max()) + 64, dict(classes=None)
    elif name == "empty":
        f = random_frags(np.random.default_rng(13), 1, 100).take(
            np.zeros(0, np.int64))
        ws, wl, geo = 1, 1500, {}
    else:
        f, ws, wl, geo, _ = _case(name)
    return f, ws, wl, dict(geo, lane_counts=False)


@pytest.mark.parametrize("name", TILED_CASES + ["sparse", "empty"])
def test_tiled_twin_equals_jax_kernel(name):
    """tiled_classic_plain == the tiled-grid _call (TPU kernel 6),
    interpret mode, tolerance 0, on the classic form (counts < 256 and up
    to 3000; windows with empty tiles, which the kernel writes as zeros);
    call_staged(grid="tiled") routes to it."""
    f, ws, wl, geo = _tiled_case(name)
    staged = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                             **geo)
    want = _jax_pileup(staged, wl, grid="tiled")
    port = pileup_v3.staged_from_numpy(staged, "cpu")
    sts = port if isinstance(port, list) else [port]
    assert all(st.form == "classic" for st in sts)
    got = sum(pileup_v3.tiled_classic_plain(st, wl) for st in sts)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(pileup_v3.call_staged(port, wl, grid="tiled"), got)
    assert np.array_equal(want, pileup_xla(f.start, f.length, f.count,
                                           f.codes, ws, wl))
    if name in ("sparse", "vals_empty_tiles", "empty"):
        assert ((sts[0].c1 - sts[0].c0) == 0).any()


def test_tiled_grid_takes_the_classic_form_only():
    """As in the JAX package, only the classic form has a tiled-grid
    kernel; pileup_v3(grid="tiled") stages it (lane_counts=False), as
    pileup_pallas_v3 does."""
    f = random_frags(np.random.default_rng(9), 300, 3000)
    for kw, match in ((dict(), "value-plane"), (dict(vals=False),
                                                "lane-count")):
        staged = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                                 **kw, **SMALL)
        with pytest.raises(ValueError, match=match):
            _jax_pileup(staged, 3000, grid="tiled")
        with pytest.raises(ValueError, match=match):
            pileup_v3.call_staged(pileup_v3.staged_from_numpy(staged, "cpu"),
                                  3000, grid="tiled")
    with pytest.raises(ValueError, match="grid"):
        pileup_v3.call_staged(pileup_v3.staged_from_numpy(staged, "cpu"),
                              3000, grid="diagonal")
    got = pileup_v3.pileup_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                              "cpu", grid="tiled", **SMALL)
    assert np.array_equal(got.numpy(), pileup_xla(f.start, f.length, f.count,
                                                  f.codes, 1, 3000))


VALS_CASES = sorted(n for n in CASES if CASES[n][4] == "vals")


def _jax_flat_vals_args(staged):
    """(ctile, covered, meta, mv, cv) of a JAX value-plane tuple as the
    Pallas call takes them, and its geometry (tile, rc, g_max)."""
    c0, c1, meta, mv, cv, _mc, tile, rc, g_max, _tag = staged
    ctile, covered = jax_v3._flat_args(c0, c1, meta.shape[0])
    args = (jnp.asarray(ctile), jnp.asarray(covered), jnp.asarray(meta),
            jnp.asarray(mv), None if cv is None else jnp.asarray(cv))
    return args, (tile, rc, g_max)


@pytest.mark.parametrize("name", VALS_CASES)
def test_split_twin_equals_jax_kernel(name):
    """flat_vals_plain (the split-plane twin) == _call_flat_vals with cv
    given (TPU kernel 4), interpret mode; call_staged routes to it."""
    f, ws, wl, geo, _ = _case(name)
    staged = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                             fused=False, **geo)
    assert staged[4] is not None
    args, (tile, rc, g_max) = _jax_flat_vals_args(staged)
    m, c = jax_v3._call_flat_vals(*args, wl, tile, rc, g_max, interpret=True)
    want = np.stack([np.asarray(m), np.asarray(c)], axis=1)
    st = pileup_v3.staged_from_numpy(staged, "cpu")
    got = pileup_v3.flat_vals_plain(st, wl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(pileup_v3.call_staged(st, wl), got)


def _total0(rng, wl):
    """A seeded nonzero int32 running total, with entries near the int32
    limit so that an add wraps, as the JAX package's int32 add does."""
    t = rng.integers(-(1 << 20), 1 << 20, size=(wl, 2)).astype(np.int32)
    t[: min(wl, 64)] = np.iinfo(np.int32).max - 3
    return t


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", VALS_CASES)
def test_vals_add_twin_equals_jax(name, fused):
    """flat_vals_add_plain == pileup_vals_add (TPU kernel 3), interpret
    mode, from a seeded nonzero total, in both plane forms; the twin adds
    in place, and rows of tiles without chunks stay as they were."""
    f, ws, wl, geo, _ = _case(name)
    staged = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                             fused=fused, **geo)
    args, (tile, rc, g_max) = _jax_flat_vals_args(staged)
    total0 = _total0(np.random.default_rng(wl), wl)
    want = np.asarray(jax_v3.pileup_vals_add(
        jnp.asarray(total0), *args, wl, tile, rc, g_max, interpret=True))
    st = pileup_v3.staged_from_numpy(staged, "cpu")
    assert st.form == ("vals" if fused else "vals_split")
    total = torch.from_numpy(total0.copy())
    out = pileup_v3.flat_vals_add(total, st, wl)
    assert out is total and np.array_equal(total.numpy(), want)
    # a row slice of a larger table is a valid total
    big = torch.zeros((wl + 10, 2), dtype=torch.int32)
    big[3 : 3 + wl] = torch.from_numpy(total0)
    pileup_v3.flat_vals_add(big[3 : 3 + wl], st, wl)
    assert np.array_equal(big[3 : 3 + wl].numpy(), want)
    assert not big[:3].any() and not big[3 + wl :].any()
    empty = np.repeat((staged[1] - staged[0]) == 0, tile)[:wl]
    assert np.array_equal(want[empty], total0[empty])
    if name.endswith("empty_tiles"):
        assert empty.any()


def test_vals_add_rejects_bad_totals():
    f, ws, wl, geo, _ = _case("vals_dense")
    st = pileup_v3.staged_from_numpy(pileup_v3.stage_v3(
        f.start, f.length, f.count, f.codes, ws, wl, **geo), "cpu")
    for bad in (torch.zeros((wl, 2), dtype=torch.int64),
                torch.zeros((wl + 1, 2), dtype=torch.int32),
                torch.zeros((2, wl), dtype=torch.int32).t()):
        with pytest.raises(ValueError, match="total"):
            pileup_v3.flat_vals_add(bad, st, wl)
    classic = pileup_v3.staged_from_numpy(pileup_v3.stage_v3(
        f.start, f.length, f.count * 300, f.codes, ws, wl, **geo), "cpu")
    with pytest.raises(ValueError, match="classic"):
        pileup_v3.flat_vals_add(torch.zeros((wl, 2), dtype=torch.int32),
                                classic[0], wl)


def _numpy_vals_pileup(staged, wl):
    """The value-plane pileup of a staged tuple by a plain loop over chunks:
    row r of chunk c (tile t) adds its 256 bytes into sub-block base + dg,
    where dg is in [0, g_max) and the sub-block in the tile; int64."""
    c0, c1, meta, mv, cv, _mc, tile, rc, g_max, _tag = staged
    plane = (mv if cv is None else np.concatenate([mv, cv], 1)).astype(
        np.int64)
    tile_sb = tile // 128
    acc = np.zeros((len(c0) * tile_sb, 256), np.int64)
    for t in range(len(c0)):
        for c in range(c0[t], c1[t]):
            dg = meta[c, 1].astype(np.int64)
            sb = dg[rc - 1] - g_max - t * tile_sb + dg
            ok = (dg >= 0) & (dg < g_max) & (sb >= 0) & (sb < tile_sb)
            np.add.at(acc, t * tile_sb + sb[ok],
                      plane[c * rc + np.nonzero(ok)[0]])
    return np.stack([acc[:, :128].reshape(-1), acc[:, 128:].reshape(-1)],
                    axis=1)[:wl]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", chip_smoke.VALS_EDGE)
def test_vals_edge_twins_equal_numpy(name, fused):
    """The twins of the value-plane kernels on the edge cases that the card
    tests and chip_smoke.py hold the kernels to (shuffled rows, padding
    between rows, padding-only chunks, 5 chunks in a tile, every byte 255,
    a ragged window, rows outside their tile): equal to a plain numpy loop;
    the add twin adds it into a total and leaves chunkless tiles alone."""
    staged, wl = chip_smoke.vals_edge_batch(name, fused)
    st = pileup_v3.staged_from_numpy(staged, "cpu")
    want = _numpy_vals_pileup(staged, wl)
    got = pileup_v3.call_staged(st, wl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    total0 = _total0(np.random.default_rng(wl), wl)
    total = torch.from_numpy(total0.copy())
    pileup_v3.flat_vals_add(total, st, wl)
    wrapped = (total0.astype(np.int64) + want + 2**31) % 2**32 - 2**31
    assert np.array_equal(total.numpy(), wrapped)
    empty = np.repeat((staged[1] - staged[0]) == 0, staged[6])[:wl]
    assert np.array_equal(total.numpy()[empty], total0[empty])
    if name == "all_255":
        assert empty.any() and want.max() > 255 * 256


def _numpy_code_pileup(staged, wl):
    """The code-word pileup of one staged tuple (classic: 8 fields, lane: 9)
    by a plain loop over chunks and rows: site l of a real row has code
    (word[l % 8] >> 2 (l // 8)) & 3 and count meta[c, 0, r] (classic) or
    (cnts[row, l % 32] >> 8 (l // 32)) & 255 (lane); cov += count where the
    code is not 3, meth += count where it is 1 or 2; int32 sums (wrapping)."""
    if len(staged) == 9:
        c0, c1, meta, words, cnts, _mc, tile, rc, g_max = staged
    else:
        (c0, c1, meta, words, _mc, tile, rc, g_max), cnts = staged, None
    tile_sb = tile // 128
    lane = np.arange(128)
    acc = np.zeros((len(c0) * tile_sb, 256), np.int64)
    for t in range(len(c0)):
        for c in range(c0[t], c1[t]):
            dg = meta[c, 1].astype(np.int64)
            base = dg[rc - 1] - g_max - t * tile_sb
            for r in range(rc):
                sb = base + dg[r]
                if not (0 <= dg[r] < g_max and 0 <= sb < tile_sb):
                    continue
                row = c * rc + r
                code = (words[row, lane % 8].astype(np.int64)
                        >> (2 * (lane // 8))) & 3
                n = (np.int64(meta[c, 0, r]) if cnts is None else
                     (cnts[row, lane % 32].astype(np.int64)
                      >> (8 * (lane // 32))) & 255)
                acc[t * tile_sb + sb, :128] += np.where(
                    (code == 1) | (code == 2), n, 0)
                acc[t * tile_sb + sb, 128:] += np.where(code != 3, n, 0)
    out = np.stack([acc[:, :128].reshape(-1), acc[:, 128:].reshape(-1)],
                   axis=1)[:wl]
    return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("form", ["classic", "lane"])
@pytest.mark.parametrize("name", chip_smoke.CODE_EDGE)
def test_code_edge_twins_equal_numpy(name, form):
    """The twins of the code-word kernels on the edge cases that the card
    tests and chip_smoke.py hold the kernels to (shuffled rows, padding
    between rows, padding-only chunks, many chunks in a tile, rows outside
    their tile, a ragged window, every count at its form's most), in both
    rc classes: equal to a plain numpy loop, on the flat grid and (classic
    form) the tiled one."""
    staged, wl = chip_smoke.code_edge_batch(name, form)
    sts = pileup_v3.staged_from_numpy(staged, "cpu")
    assert [st.form for st in sts] == [form] * 2
    assert [st.rc for st in sts] == list(chip_smoke.CODE_CLASSES)
    want = sum(_numpy_code_pileup(st, wl).astype(np.int64) for st in staged)
    got = pileup_v3.call_staged(sts, wl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if form == "classic":
        assert np.array_equal(pileup_v3.call_staged(sts, wl,
                                                    grid="tiled").numpy(),
                              want)
    if name == "max_counts":
        assert not want[2048:].any() and want[:, 1].max() > 2**16
    if name == "padding_chunk":
        assert not want[1024:2048].any() and want[:1024].any()


def _jax_exact(staged):
    """Whether the JAX code-word kernels' f32 one-hot dots are exact on a
    staged tuple: each chunk's per-sub-block sum of a site's counts must
    stay below 2^24 (pileup_tpu3.py:145-151, :320-322)."""
    meta, rc, g_max = staged[2], staged[-2], staged[-1]
    cnt = (np.full(meta[:, 0].shape, 255, np.int64) if len(staged) == 9
           else meta[:, 0].astype(np.int64))
    dg = meta[:, 1]
    sums = [np.where(dg == g, cnt, 0).sum(axis=1).max() for g in range(g_max)]
    return max(sums) < 2**24


@pytest.mark.parametrize("form", ["classic", "lane"])
@pytest.mark.parametrize("name", chip_smoke.CODE_EDGE)
def test_code_edge_twins_equal_jax(name, form):
    """The code-word twins == the JAX package's call_staged (Pallas,
    interpret mode) on each edge case, per rc class, flat and (classic)
    tiled grid, tolerance 0; skipped only for the one tuple where the JAX
    kernel's f32 dot is not exact (the classic max_counts case's rc-128
    class: 127 rows of count 2^20 in one chunk's sub-block), where the
    numpy test above holds the twin."""
    staged, wl = chip_smoke.code_edge_batch(name, form)
    exact = [_jax_exact(st) for st in staged]
    assert exact == ([True, False] if (name, form) == ("max_counts",
                                                       "classic")
                     else [True, True])
    for one, ok in zip(staged, exact):
        if not ok:
            continue
        st = pileup_v3.staged_from_numpy(one, "cpu")
        want = _jax_pileup(one, wl)
        assert np.array_equal(pileup_v3.call_staged(st, wl).numpy(), want)
        if form == "classic":
            assert np.array_equal(_jax_pileup(one, wl, grid="tiled"), want)
            assert np.array_equal(
                pileup_v3.tiled_classic_plain(st, wl).numpy(), want)


def test_staged_from_numpy_rejects_overlapping_ranges():
    """The tiled kernel finds a chunk's tile by a search of c1: tiles' chunk
    ranges that overlap or descend are refused on the host; and a batch
    whose rows the kernels could not index with int32 is refused before
    any launch."""
    staged, wl = chip_smoke.code_edge_batch("many_chunks")
    bad = list(staged[1])
    bad[0], bad[1] = bad[0].copy(), bad[1].copy()
    bad[0][2] -= 1  # tile 2 starts inside tile 1's range
    with pytest.raises(ValueError, match="overlap or descend"):
        pileup_v3.staged_from_numpy(tuple(bad), "cpu")
    st = pileup_v3.staged_from_numpy(staged[1], "cpu")
    n_chunks = 2**31 // st.rc
    huge = pileup_v3.Staged(
        "classic", st.c0, st.c1, st.meta[:1].expand(n_chunks, 2, st.rc),
        st.rows[:1].expand(n_chunks * st.rc, 8), st.tile, st.rc, st.g_max)
    for grid in ("flat", "tiled"):
        with pytest.raises(ValueError, match="int32"):
            pileup_v3.call_staged(huge, wl, grid=grid)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_equals_twin(cuda_device, name):
    f, ws, wl, geo, form = _case(name)
    staged = pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                                **geo)
    port = pileup_v3.staged_from_numpy(staged, cuda_device)
    kernel, plain = KERNELS[form]
    before = kernel.launches
    got = pileup_v3.call_staged(port, wl)
    torch.cuda.synchronize()
    assert kernel.launches > before
    want = sum(plain(st, wl) for st in (port if isinstance(port, list)
                                        else [port]))
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), pileup_xla(
        f.start, f.length, f.count, f.codes, ws, wl))


@pytest.mark.cuda
@pytest.mark.parametrize("name", TILED_CASES + ["sparse", "empty"])
def test_cuda_tiled_kernel_equals_twin(cuda_device, name):
    """tiled_classic on the card == its twin, empty tiles written as
    zeros (the output starts from garbage: the launch zeroes it)."""
    f, ws, wl, geo = _tiled_case(name)
    port = pileup_v3.staged_from_numpy(pileup_v3.stage_v3(
        f.start, f.length, f.count, f.codes, ws, wl, **geo), cuda_device)
    torch.full((wl, 2), 7, dtype=torch.int32, device=cuda_device)  # dirty
    before = pileup_v3.tiled_classic.launches
    got = pileup_v3.call_staged(port, wl, grid="tiled")
    torch.cuda.synchronize()
    assert pileup_v3.tiled_classic.launches > before
    want = sum(pileup_v3.tiled_classic_plain(st, wl)
               for st in (port if isinstance(port, list) else [port]))
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), pileup_xla(
        f.start, f.length, f.count, f.codes, ws, wl))


@pytest.mark.cuda
@pytest.mark.parametrize("name", VALS_CASES)
def test_cuda_split_and_add_kernels_equal_twins(cuda_device, name):
    """flat_vals and flat_vals_add (both plane forms, from a seeded nonzero
    total) equal their twins on the card."""
    f, ws, wl, geo, _ = _case(name)
    for fused in (True, False):
        st = pileup_v3.staged_from_numpy(pileup_v3.stage_v3(
            f.start, f.length, f.count, f.codes, ws, wl, fused=fused, **geo),
            cuda_device)
        if not fused:
            before = pileup_v3.flat_vals.launches
            got = pileup_v3.call_staged(st, wl)
            torch.cuda.synchronize()
            assert pileup_v3.flat_vals.launches == before + 1
            assert torch.equal(got, pileup_v3.flat_vals_plain(st, wl))
        total0 = torch.from_numpy(_total0(np.random.default_rng(wl), wl)).to(
            cuda_device)
        total = total0.clone()
        before = pileup_v3.flat_vals_add.launches
        pileup_v3.flat_vals_add(total, st, wl)
        torch.cuda.synchronize()
        assert pileup_v3.flat_vals_add.launches == before + 1
        assert torch.equal(total,
                           pileup_v3.flat_vals_add_plain(total0.clone(), st,
                                                         wl))


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.VALS_EDGE)
def test_cuda_vals_edge_cases(cuda_device, name):
    """The value-plane kernels on the card == their twins, tolerance 0, on
    each edge case, in both plane forms; the add from a seeded nonzero
    total, fresh (16-byte aligned) and as an 8-byte-aligned row slice of a
    larger table."""
    for fused in (True, False):
        staged, wl = chip_smoke.vals_edge_batch(name, fused)
        st = pileup_v3.staged_from_numpy(staged, cuda_device)
        kernel = pileup_v3.flat_vals_fused if fused else pileup_v3.flat_vals
        plain = (pileup_v3.flat_vals_fused_plain if fused
                 else pileup_v3.flat_vals_plain)
        before = kernel.launches
        got = kernel(st, wl)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(got, plain(st, wl))
        base = torch.from_numpy(_total0(np.random.default_rng(wl),
                                        wl + 2)).to(cuda_device)
        for off in (0, 1):  # rows from 0: 16-byte aligned; from 1: 8 only
            table = base.clone()
            total = table[off : off + wl]
            assert total.data_ptr() % 16 == 8 * off
            pileup_v3.flat_vals_add(total, st, wl)
            torch.cuda.synchronize()
            assert torch.equal(total, pileup_v3.flat_vals_add_plain(
                base[off : off + wl].clone(), st, wl))
            keep = torch.ones(wl + 2, dtype=torch.bool, device=cuda_device)
            keep[off : off + wl] = False
            assert torch.equal(table[keep], base[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.CODE_EDGE)
def test_cuda_code_edge_cases(cuda_device, name):
    """The code-word kernels on the card == their twins, tolerance 0, on
    each edge case in both rc classes: flat_classic and tiled_classic on
    the classic form (tiled into an output that starts dirty), flat_lc on
    the lane form."""
    for form, kernels in (("classic", (pileup_v3.flat_classic,
                                       pileup_v3.tiled_classic)),
                          ("lane", (pileup_v3.flat_lc,))):
        staged, wl = chip_smoke.code_edge_batch(name, form)
        for st in pileup_v3.staged_from_numpy(staged, cuda_device):
            for kernel in kernels:
                plain = getattr(pileup_v3, kernel.__name__ + "_plain")
                torch.full((wl, 2), 7, dtype=torch.int32,
                           device=cuda_device)  # dirty the allocator
                before = kernel.launches
                got = kernel(st, wl)
                torch.cuda.synchronize()
                assert kernel.launches == before + 1
                assert torch.equal(got, plain(st, wl))


@pytest.mark.cuda
def test_cuda_launch_keeps_current_device():
    """Each kernel, launched on the last visible card, leaves the caller's
    current device as it was (the launcher sets no device of its own)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    for name in ("vals_dense", "classic_counts_3000"):
        f, ws, wl, geo, _ = _case(name)
        for kw in (dict(fused=True), dict(fused=False), dict(vals=False)):
            port = pileup_v3.staged_from_numpy(pileup_v3.stage_v3(
                f.start, f.length, f.count, f.codes, ws, wl, **kw, **geo),
                dev)
            sts = port if isinstance(port, list) else [port]
            for st in sts:
                out = pileup_v3.call_staged(st, wl)
                assert torch.cuda.current_device() == 0
                assert out.device == dev
                if st.form == "classic":
                    pileup_v3.call_staged(st, wl, grid="tiled")
                    assert torch.cuda.current_device() == 0
                if st.form != "classic":
                    total = torch.zeros((wl, 2), dtype=torch.int32,
                                        device=dev)
                    pileup_v3.flat_vals_add(total, st, wl)
                    assert torch.cuda.current_device() == 0
            # a later default allocation lands on the current device
            assert torch.empty(1, device="cuda").device.index == 0
    torch.cuda.synchronize(dev)
