"""The order of work of block_sums' kernels (csrc/reduceat.cu), modelled in
numpy index for index and held to JAX's ops/reduceat.py::
reduce_data_to_blocks (numpy past 2^31, where JAX's int32 segment_sum
wraps), tolerance 0.

The model does what the two launches do. The runs kernel: run r is the
blocks [r RUN, (r + 1) RUN), one warp's, a lane each; a block of more than
SPAN_ROWS rows is long (zeros now, listed for the pieces kernel; without
that launch, summed by the wide body); the
other non-empty blocks' hull [lo, hi) picks the body. A hull of at most
SPAN_ROWS rows is staged byte for byte as the kernel stages it (its
16-byte groups that cover it copied whole where they lie inside the
table and row by row where they do not, at a simulated address of the
table, the stage rows past the last group to the last chunk's end
zeroed, every stage byte that is read written once, nothing outside the
stage or the table touched, the rest random), cut into at most 32 chunks of C = 2^lg stage rows (at least a 32-bit
word) that the lanes sum in an order that puts the warp's 32 loads in 32
banks, whose uint32 prefixes a warp scan gives, and each block is its rows (at
most C) or P(e) - P(s) in uint32; a wider hull sums each block from the
table (the warp body). The pieces kernel: the long blocks' pieces of
PIECE_ROWS rows, numbered across the list, CTA g mod G summing piece g
with 16-byte vectors (thread k the vectors k, k + 256, ..., uint32
accumulators) and the rows outside them, each piece added into its
block. Cases: sorted, unsorted and overlapping blocks, NA and empty
blocks, blocks clipped at N, runs that mix both bodies, blocks at and
over the budget, pieces, uint8 and uint16 tables at every row alignment
of the table's address, the whole-genome block past 2^31, and the split
over 4 stand-in shards."""

import os.path as op
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from wgbs_tools_tpu.ops import reduceat as jred  # noqa: E402
from wgbs_tools_tpu_torch.ops import reduceat  # noqa: E402
from wgbs_tools_tpu_torch.parallel.mesh import shard_devices  # noqa: E402

RUN, SPAN, PIECE = reduceat.RUN, reduceat.SPAN_ROWS, reduceat.PIECE_ROWS
WARP = 32  # a run is a warp's blocks, a lane each
THREADS = 256  # the pieces kernel's
SRC = op.join(op.dirname(op.abspath(reduceat.__file__)), "..", "csrc",
              "reduceat.cu")
U32 = 0xFFFFFFFF


def _rows_of(mem, base, addr, nrows, dtype):
    """nrows rows of the table at address addr (the table at base)."""
    start = addr - base
    rb = 2 * np.dtype(dtype).itemsize
    assert start % rb == 0 and 0 <= start and start + nrows * rb <= len(mem)
    return np.frombuffer(mem, dtype=dtype, count=2 * nrows,
                         offset=start).reshape(nrows, 2)


def _outside_vectors(A, Z, bulk_start, bulk_end, rb):
    """The rows the threads load around the 16-byte part [A16, Z16):
    [A, head_end) and [tail_start, Z), as the kernels cut them."""
    A16 = (A + 15) & ~15
    head_end = min(A16, Z)
    tail_start = bulk_end if bulk_end > bulk_start else head_end
    head, tail = (head_end - A) // rb, (Z - tail_start) // rb
    assert head < 16 // rb and tail < 16 // rb  # threads 0.. and 32..
    return (A, head), (tail_start, tail)


def stage_hull(mem, base, lo, hi, dtype, rng):
    """The runs kernel's staging of rows [lo, hi) (the shared memory that
    it does not write holds random bytes here): the 16-byte groups from the
    boundary at or below the hull's first byte to the one at or above its
    end, each copied whole (cp.async) where it lies inside the table, else
    row by row with the rows outside the table 0; then 0 from the last
    group to the last chunk's end. Every stage byte the sums read is
    written once, nothing outside the stage, nothing read outside the
    table. Returns (the stage's rows, r0 the hull's first stage row, rows
    its end, lg)."""
    rb = 2 * np.dtype(dtype).itemsize
    rpg = 16 // rb  # rows a group
    end = base + len(mem)
    A, Z = base + lo * rb, base + hi * rb
    Af = A & ~15
    groups = (((Z + 15) & ~15) - Af) // 16
    size = reduceat.STAGE_ROWS * rb  # stage_bytes<T>()
    stage = rng.integers(0, 256, size=size).astype(np.uint8)
    written = np.zeros(size, np.int64)

    def put(at, data):
        stage[at:at + len(data)] = data
        written[at:at + len(data)] += 1

    def inside(at, n):
        return at >= base and at + n <= end

    edge = {0, groups - 1}
    for g in range(groups):
        at = Af + 16 * g
        if inside(at, 16):
            put(16 * g, np.frombuffer(mem, np.uint8, 16, at - base))
        else:  # finish_stage, row by row
            assert g in edge
            for j in range(rpg):
                row = at + j * rb
                put(16 * g + j * rb,
                    np.frombuffer(mem, np.uint8, rb, row - base)
                    if inside(row, rb) else np.zeros(rb, np.uint8))
    r0 = (A - Af) // rb
    rows = r0 + hi - lo
    lg = 1 if rb == 2 else 0
    while ((rows + (1 << lg) - 1) >> lg) > RUN:
        lg += 1
    C = 1 << lg
    stop = -(-rows // C) * C
    if stop > groups * rpg:
        put(groups * 16, np.zeros((stop - groups * rpg) * rb, np.uint8))
    top = max(stop, groups * rpg) * rb
    assert top <= size
    assert (written[:top] == 1).all()  # each stage byte read, once
    return stage.view(dtype).reshape(-1, 2), r0, rows, lg


def rotation(wc):
    """The kernel's rot of each lane for chunks of wc words."""
    return [lane if wc >= WARP else lane >> (5 - (wc.bit_length() - 1))
            for lane in range(WARP)]


def staged_sums(stage, r0, rows, lg, xs, xe):
    """The staged body's answers for blocks [xs, xe) of the hull (rows
    relative to lo; the hull is stage rows [r0, rows)): chunk t of C = 2^lg
    stage rows summed by thread t, the warp's loads of each step in 32
    banks, uint32 throughout."""
    C = 1 << lg
    wc = C * stage.dtype.itemsize * 2 // 4
    rot = rotation(wc)
    for i in range(wc):  # word (i + rot) mod wc of lane l's chunk
        assert len({(lane * wc + (i + rot[lane]) % wc) % 32
                    for lane in range(WARP)}) == WARP
    h = stage.astype(np.int64)
    chunks = np.zeros((RUN, 2), np.int64)
    for t in range(RUN):
        if (t << lg) < rows:
            chunks[t] = h[t * C:(t + 1) * C].sum(axis=0)
    assert chunks.max() <= U32
    cp = np.zeros((RUN + 1, 2), np.int64)
    cp[1:] = np.cumsum(chunks, axis=0) & U32
    out, formula = [], 0
    for s, e in zip(xs + r0, xe + r0):
        if e - s <= C:
            out.append(h[s:e].sum(axis=0) & U32)
        else:  # P(e) - P(s), P(x) = cp[x >> lg] + rows [chunk start, x)
            ks, ke = s >> lg, e >> lg
            ms = h[ks << lg:s].sum(axis=0)
            me = h[ke << lg:e].sum(axis=0)
            assert e - (ke << lg) < C and s - (ks << lg) < C
            out.append((me + cp[ke] - cp[ks] - ms) & U32)
            formula += 1
    return out, formula


def add_vectors(words, itemsize):
    """add_vec<T> over uint32 words: (meth, cov) sums."""
    w = words.astype(np.int64)
    if itemsize == 1:
        return ((w & 0xFF) + ((w >> 16) & 0xFF)).sum(), (
            ((w >> 8) & 0xFF) + (w >> 24)).sum()
    return (w & 0xFFFF).sum(), (w >> 16).sum()


def piece_sums(mem, base, r0, r1, dtype):
    """The pieces kernel's sums of rows [r0, r1): 16-byte vectors a thread
    strided by THREADS (uint32 accumulators), the rows around them."""
    itemsize = np.dtype(dtype).itemsize
    rb = 2 * itemsize
    A, Z = base + r0 * rb, base + r1 * rb
    A16, Z16 = (A + 15) & ~15, Z & ~15
    m = c = 0
    covered = 0
    if Z16 > A16:
        words = np.frombuffer(mem, np.uint32, (Z16 - A16) // 4, A16 - base)
        vecs = words.reshape(-1, 4)
        for k in range(THREADS):  # thread k's vectors
            tm, tc = add_vectors(vecs[k::THREADS], itemsize)
            assert tm <= U32 and tc <= U32
            m, c = m + tm, c + tc
        covered += (Z16 - A16) // rb
    for at, k in _outside_vectors(A, Z, A16, Z16, rb):
        rows = _rows_of(mem, base, at, k, dtype).astype(np.int64)
        m, c = m + rows[:, 0].sum(), c + rows[:, 1].sum()
        covered += k
    assert covered == r1 - r0  # the rows of the piece, each once
    return m, c


def block_sums_model(data, bounds, align=0, long_blocks=True):
    """block_sums' order of work on a table at an address == align (mod
    16); long_blocks False: no pieces launch, a long block is summed by its
    warp's wide body. Returns (int64 (B, 2) sums, stats)."""
    dtype = data.dtype
    itemsize = dtype.itemsize
    assert align % (2 * itemsize) == 0
    mem = np.ascontiguousarray(data).tobytes()
    base = 4096 + align
    B = bounds.shape[0]
    out = np.zeros((B, 2), np.int64)
    stats = {"staged": 0, "warp": 0, "none": 0, "long": [], "pieces": 0,
             "formula": 0}
    rng = np.random.default_rng(align)
    for r in range(-(-B // RUN)):
        b = np.arange(r * RUN, min(B, (r + 1) * RUN))
        s, e = bounds[b, 0], bounds[b, 1]
        is_long = (e - s > SPAN) & long_blocks
        used = (e > s) & ~is_long
        out[b[~used]] = 0
        stats["long"] += b[is_long].tolist()
        if not used.any():
            stats["none"] += 1
            continue
        lo, hi = int(s[used].min()), int(e[used].max())
        if hi - lo > SPAN:
            stats["warp"] += 1
            for k in np.nonzero(used)[0]:
                out[b[k]] = _rows_of(mem, base, base + 2 * itemsize * s[k],
                                     e[k] - s[k], dtype).sum(
                                         axis=0, dtype=np.int64)
            continue
        stats["staged"] += 1
        stage, r0, rows, lg = stage_hull(mem, base, lo, hi, dtype, rng)
        sums, formula = staged_sums(stage, r0, rows, lg, s[used] - lo,
                                    e[used] - lo)
        out[b[used]] = np.array(sums)
        stats["formula"] += formula
    # the pieces kernel over the long list
    first = 0
    for b in stats["long"]:
        s, e = int(bounds[b, 0]), int(bounds[b, 1])
        pieces = -(-(e - s) // PIECE)
        for g in range(first, first + pieces):  # CTA g mod the grid
            r0 = s + (g - first) * PIECE
            m, c = piece_sums(mem, base, r0, min(r0 + PIECE, e), dtype)
            out[b] += (m, c)
        first += pieces
    stats["pieces"] = first
    return out, stats


def _contiguous(rng, n_blocks, first=0, max_len=120):
    """Blocks that tile rows from `first` on, lengths 1-max_len (geometric,
    mean ~26, as segment's blocks): (s, e) rows."""
    lens = np.minimum(rng.geometric(1 / 26, size=n_blocks), max_len)
    e = first + np.cumsum(lens)
    return e - lens, e


def case(name, seed=4):
    """(data, starts, ends, base) of a test case (1-based blocks)."""
    rng = np.random.default_rng(seed)
    n = 300_000
    data = rng.integers(0, 256, size=(n, 2)).astype(np.uint8)
    s, e = _contiguous(rng, 3000)
    if name == "unsorted_in_runs":  # each run's blocks permuted: staged
        p = np.concatenate([k + rng.permutation(min(RUN, len(s) - k))
                            for k in range(0, len(s), RUN)])
        s, e = s[p], e[p]
    elif name == "unsorted":  # permuted over the table: wide hulls
        p = rng.permutation(len(s))
        s, e = s[p], e[p]
    elif name == "overlapping":  # steps shorter than lengths, duplicates
        s = np.cumsum(rng.integers(0, 30, size=3000))
        e = s + rng.integers(1, 300, size=3000)
        s[5::17], e[5::17] = s[4::17][:len(s[5::17])], e[4::17][:len(
            e[5::17])]
    elif name == "na_empty_clipped":  # the table ends under the last
        # blocks: some clipped, some past it
        s, e = s.copy(), e.copy()
        n = int(e[-20])
        data = data[:n]
        s[::7] = -2  # NA (-1) once the rows are made 1-based
        e[::11] = s[::11]
        s[-5:], e[-5:] = n - 3, n + 50
    elif name == "mixed_runs":  # staged, sparse (warp), long among compact
        s1, e1 = _contiguous(rng, RUN)
        s2 = np.sort(rng.integers(e1[-1], n - 2000, size=RUN))
        e2 = s2 + rng.integers(1, 40, size=RUN)
        s3, e3 = _contiguous(rng, RUN, first=1000)
        s3[7], e3[7] = 100, 100 + SPAN + 1       # long, in a compact run
        s3[20], e3[20] = 50_000, 50_000 + 3 * PIECE + 5  # 4 pieces
        s, e = np.concatenate([s1, s2, s3]), np.concatenate([e1, e2, e3])
    elif name == "budget":  # blocks at and over the staged budget, each
        # the one non-empty block of its run
        sizes = np.array([SPAN, SPAN + 1, SPAN - 1, 2 * SPAN, PIECE,
                          PIECE + 1, 1, 2])
        first = np.arange(len(sizes)) * 20_000
        s = np.repeat(first, RUN)
        e = s.copy()
        e[::RUN] += sizes
    elif name == "uint16":
        data = rng.integers(0, 65536, size=(n, 2)).astype(np.uint16)
    elif name != "sorted":
        raise KeyError(name)
    return data, s + 1, e + 1, 1


CASES = ("sorted", "unsorted_in_runs", "unsorted", "overlapping",
         "na_empty_clipped", "mixed_runs", "budget", "uint16")


def _jax(data, s, e, base):
    return jred.reduce_data_to_blocks(data, s, e, base=base)


@pytest.mark.parametrize("name", CASES)
def test_model_equals_jax(name):
    data, s, e, base = case(name)
    bounds = reduceat.block_bounds(s, e, base, data.shape[0])
    got, st = block_sums_model(data, bounds)
    assert np.array_equal(got, _jax(data, s, e, base))
    bodies = {"sorted": ("staged",), "unsorted_in_runs": ("staged",),
              "unsorted": ("warp",), "overlapping": ("staged",),
              "na_empty_clipped": ("staged",),
              "mixed_runs": ("staged", "warp"), "budget": ("staged",),
              "uint16": ("staged",)}[name]
    for body in ("staged", "warp"):
        assert (st[body] > 0) == (body in bodies), (body, st)
    if name in ("mixed_runs", "budget"):
        assert st["long"] and st["pieces"] > len(st["long"])
        assert st["formula"] > 0
    else:
        assert not st["long"]


@pytest.mark.parametrize("name", ["mixed_runs", "budget"])
def test_model_without_the_pieces_launch_equals_jax(name):
    """long_blocks False: no block is listed, a long block's warp sums it
    by the wide body; the same sums."""
    data, s, e, base = case(name)
    bounds = reduceat.block_bounds(s, e, base, data.shape[0])
    got, st = block_sums_model(data, bounds, long_blocks=False)
    assert np.array_equal(got, _jax(data, s, e, base))
    assert not st["long"] and st["warp"] > 0


@pytest.mark.parametrize("align", [0, 2, 6, 8, 14])
@pytest.mark.parametrize("name", ["sorted", "mixed_runs", "uint16"])
def test_model_at_every_alignment_equals_jax(name, align):
    """The staging and the pieces at every row alignment of the table's
    address: the bulk copy's 16-byte ends move, the rows around it too."""
    data, s, e, base = case(name, seed=5)
    if data.dtype == np.uint16 and align % 4:
        align += 2
    bounds = reduceat.block_bounds(s, e, base, data.shape[0])
    got, _ = block_sums_model(data, bounds, align=align)
    assert np.array_equal(got, _jax(data, s, e, base))


def test_model_whole_genome_block_equals_numpy():
    """The whole-genome block at coverage 255 (cut to 9,000,000 sites, its
    coverage still past 2^31), with chip_smoke's other edges: pieces over
    the card, == numpy (JAX's int32 sums wrap here)."""
    data, s, e = chip_smoke.block_edge_batch("whole_genome_255",
                                             n=9_000_000)
    bounds = reduceat.block_bounds(s, e, 1, data.shape[0])
    got, st = block_sums_model(data, bounds, align=2)
    want = np.array([data[a:b].sum(axis=0, dtype=np.int64)
                     for a, b in bounds])
    assert np.array_equal(got, want) and got[0, 1] > 2**31
    assert st["long"][0] == 0 and st["pieces"] >= 9_000_000 // PIECE


@pytest.mark.parametrize("name", [n for n in chip_smoke.BLOCK_EDGE
                                  if n != "whole_genome_255"])
def test_model_on_block_edge_batches_equals_jax(name):
    """chip_smoke.py's other block_sums edge batches (cut to 2,000,000
    sites) through the model == JAX's per-block path."""
    data, s, e = chip_smoke.block_edge_batch(name, n=2_000_000)
    bounds = reduceat.block_bounds(s, e, 1, data.shape[0])
    got, st = block_sums_model(data, bounds)
    assert np.array_equal(got, jred.reduce_data_to_blocks(data, s, e))


def test_split_over_4_stand_ins_through_the_model(monkeypatch):
    """reduce_data_to_blocks over 4 stand-in shards with the kernels'
    order of work in place of block_sums: each shard's clipped bounds,
    the partials added == JAX."""
    calls = []

    def model(d, bd, long_blocks=True):
        got, _ = block_sums_model(d.numpy(), bd.numpy(),
                                  long_blocks=long_blocks)
        calls.append(long_blocks)
        return torch.from_numpy(got)

    monkeypatch.setattr(reduceat, "block_sums", model)
    data, s, e, base = case("mixed_runs")
    got = reduceat.reduce_data_to_blocks(
        data, s, e, base=base, device=shard_devices("cpu", n_shards=4))
    assert len(calls) == 4 and any(calls)  # a shard holds a long block
    assert np.array_equal(got, _jax(data, s, e, base))


def test_geometry_equals_the_kernel_source():
    """ops/reduceat.py's RUN, SPAN_ROWS and PIECE_ROWS are
    csrc/reduceat.cu's."""
    with open(SRC) as f:
        src = f.read()
    assert re.search(r"constexpr int WARP = (\d+);", src).group(1) == str(
        RUN)
    assert re.search(r"constexpr int RUN = WARP;", src)
    assert re.search(r"constexpr int THREADS = (\d+);", src).group(1) == str(
        THREADS)
    for name, want in (("SPAN_ROWS", SPAN), ("PIECE_ROWS", PIECE)):
        m = re.search(rf"constexpr int64_t {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    m = re.search(r"constexpr int STAGE_ROWS = (\d+);", src)
    assert m and int(m.group(1)) == reduceat.STAGE_ROWS


@pytest.mark.parametrize("name", CASES)
def test_run_bodies_count_the_models_runs(name):
    """chip_smoke.run_bodies (which the smoke and kernel_ab.py print for
    the main path's launch) counts the runs the model takes by each body."""
    data, s, e, base = case(name)
    bounds = reduceat.block_bounds(s, e, base, data.shape[0])
    for long_blocks in (True, False):
        _, st = block_sums_model(data, bounds, long_blocks=long_blocks)
        got = chip_smoke.run_bodies(bounds, long_blocks)
        assert got == {"staged": st["staged"], "wide": st["warp"],
                       "none": st["none"], "long": len(st["long"])}
