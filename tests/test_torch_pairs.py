"""The port's pair counts (ops/pairs.py) and pat2pairs against the JAX
package, tolerance 0: the fold's twin against _pairs_batch and
_pairs_accum, pair_counts on windows that cut fragments, StreamingPairs
over tiny slabs against JAX's one-shot pair_counts and StreamingPairs,
deep counts, and the CLI's bytes against the JAX CLI's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.formats.pat import frags_to_bytes, write_pat  # noqa: E402
from wgbs_tools_tpu.ops import pairs as jpairs  # noqa: E402
from wgbs_tools_tpu_torch.formats.pat import PatFrags, iter_pat  # noqa: E402
from wgbs_tools_tpu_torch.ops import pairs  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

N = 3000


def _frags(seed, n=2500, max_len=20, max_count=5, h_rate=0.05, lo=1):
    f = random_frags(np.random.default_rng(seed), n, N - lo - 5,
                     max_len=max_len, max_count=max_count, h_rate=h_rate,
                     dot_rate=0.08, site_base=lo)
    return PatFrags(f.start, f.length, f.count, f.codes, f.chrom_id,
                    f.chrom_names)


def _cols(f, s):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        (f.start.astype(np.int64) - s).astype(np.int32),
        f.length.astype(np.int32), f.count.astype(np.int32), f.codes)]


# windows: the whole range, one that cuts fragments at both ends (some
# start before it), a short one at the last site
WINDOWS = {"whole": (1, N + 1), "middle": (700, 2100), "last": (N - 3, N + 1)}


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("deep", [False, True])
def test_twin_equals_jax_pairs_batch(window, deep):
    """pair_counts_add_plain on a zeroed table == _pairs_batch on every
    fragment, cut ones and start_rel < 0 included (no slice_sites)."""
    f = _frags(1, max_count=3000 if deep else 5)
    s, e = WINDOWS[window]
    want = np.asarray(jpairs._pairs_batch(
        jnp.asarray(f.start.astype(np.int32) - s),
        jnp.asarray(f.length), jnp.asarray(f.count), jnp.asarray(f.codes),
        e - s))
    cols = _cols(f, s)
    assert window == "whole" or int(cols[0].min()) < 0
    table = torch.zeros((e - s, 4), dtype=torch.int32)
    before = pairs.pair_counts_add.launches
    pairs.pair_counts_add(table, *cols)
    assert pairs.pair_counts_add.launches == before  # the CPU takes the twin
    assert np.array_equal(table.numpy(), want)


def test_twin_adds_as_jax_pairs_accum():
    """The fold adds into a nonzero table as _pairs_accum does."""
    f = _frags(2, max_count=3000)
    acc0 = np.random.default_rng(3).integers(0, 1000, (N, 4)).astype(
        np.int32)
    want = np.asarray(jpairs._pairs_accum(
        jnp.asarray(acc0), jnp.asarray(f.start.astype(np.int32) - 1),
        jnp.asarray(f.length), jnp.asarray(f.count), jnp.asarray(f.codes)))
    table = torch.from_numpy(acc0.copy())
    pairs.pair_counts_add(table, *_cols(f, 1))
    assert np.array_equal(table.numpy(), want)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_pair_counts_equals_jax(window):
    f = _frags(4)
    want = jpairs.pair_counts(f, WINDOWS[window])
    got = pairs.pair_counts(f, WINDOWS[window], device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_pair_counts_edges_by_hand():
    """H and '.' never count, a pair counts at its second site, the last
    site counts, length-1 fragments and positions past length add
    nothing, count 3000 goes through unchanged."""
    T, C, H, D = 0, 1, 2, 3
    codes = np.array([[C, C, T, H, C, T],
                      [T, D, T, C, D, D],
                      [C, D, D, D, D, D],    # length 1
                      [T, C, C, T, C, C]],   # length 3: cols >= 3 ignored
                     dtype=np.uint8)
    start = np.array([1, 3, 9, 9], np.int32)
    length = np.array([6, 4, 1, 3], np.int32)
    count = np.array([3000, 2, 5, 7], np.int32)
    f = PatFrags(start, length, count, codes, np.zeros(4, np.int16),
                 ["chr1"])
    got = pairs.pair_counts(f, (1, 11), device="cpu")
    want = np.zeros((10, 4), np.int32)
    want[1, 3] += 3000  # C C at sites 1, 2
    want[2, 2] += 3000  # C T at sites 2, 3
    want[5, 2] += 3000  # C T at sites 5, 6 (H at 4 drops 3-4 and 4-5)
    want[5, 1] += 2     # T C at sites 5, 6 of the second
    want[9, 1] += 7     # T C at 9, 10; 10-11 is past the window
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpairs.pair_counts(f, (1, 11)))


def test_pair_edge_twin_equals_jax():
    """chip_smoke.py's edge batch for pair_counts (H and '.', start_rel <
    0, the last site, length 1, counts up to 3000): the twin ==
    _pairs_batch."""
    start, length, count, codes, n = chip_smoke.pair_edge_batch()
    want = np.asarray(jpairs._pairs_batch(
        jnp.asarray(start), jnp.asarray(length), jnp.asarray(count),
        jnp.asarray(codes), n))
    table = torch.zeros((n, 4), dtype=torch.int32)
    pairs.pair_counts_add(table, *[torch.from_numpy(a) for a in (
        start, length, count, codes)])
    assert int(start.min()) < 0 and int(want[n - 1].sum()) > 0
    assert np.array_equal(table.numpy(), want)


def test_streaming_pairs_over_tiny_slabs_equals_jax(tmp_path):
    """StreamingPairs over ~40 slabs of a pat == JAX's StreamingPairs and
    its one-shot pair_counts on the whole pat."""
    f = _frags(5, n=4000, max_count=3000)
    pat = tmp_path / "p.pat"  # text: iter_pat's slabs are 2,000 bytes
    pat.write_bytes(frags_to_bytes(f))
    window = (1, N + 1)
    sp = pairs.StreamingPairs(window, device="cpu")
    jsp = jpairs.StreamingPairs(window)
    n_slabs = 0
    for chunk in iter_pat(str(pat), chunk_bytes=2000):
        sp.add(chunk)
        jsp.add(chunk)
        n_slabs += 1
    assert n_slabs > 20
    got = sp.result()
    assert np.array_equal(got, jsp.result())
    assert np.array_equal(got, jpairs.pair_counts(f, window))


def test_cli_pat2pairs_equals_jax_cli(tmp_path, mini_genome, monkeypatch):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    n = mini_genome.get_nr_sites()
    f = random_frags(np.random.default_rng(6), 3000, n - 30, max_len=16,
                     max_count=3000, h_rate=0.03)
    pat = str(tmp_path / "s.pat.gz")
    write_pat(f, pat)
    for who in "jt":
        (tmp_path / who).mkdir()
    assert jax_main(["pat2pairs", pat, "-o", str(tmp_path / "j")]) == 0
    assert port_main(["pat2pairs", pat, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    want = (tmp_path / "j" / "s.pairs").read_bytes()
    assert len(want) == 16 * n
    assert (tmp_path / "t" / "s.pairs").read_bytes() == want

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["pat2pairs", pat, "-o", str(tmp_path / "t"), "-f"])


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("max_len", [20, 90])
def test_cuda_pair_counts_equals_twin(cuda_device, window, max_len):
    f = _frags(7, max_len=max_len, max_count=3000)
    s, e = WINDOWS[window]
    cols = _cols(f, s)
    acc0 = torch.from_numpy(np.random.default_rng(8).integers(
        0, 100, (e - s, 4)).astype(np.int32))
    before = pairs.pair_counts_add.launches
    got = pairs.pair_counts_add(acc0.to(cuda_device),
                                *[c.to(cuda_device) for c in cols])
    torch.cuda.synchronize()
    assert pairs.pair_counts_add.launches == before + 1
    assert torch.equal(got.cpu(), pairs.pair_counts_add_plain(acc0.clone(),
                                                              *cols))


# (edge case, is_sorted): None checks on the card, False sorts, True (a
# sorted batch only) skips both
PAIR_EDGE_HINTS = [(name, hint) for name in chip_smoke.PAIR_EDGE
                   for hint in ((None, False) if name == "unsorted"
                                else (None, True, False))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,hint", PAIR_EDGE_HINTS)
def test_cuda_pair_edge_equals_twin(cuda_device, monkeypatch, name, hint):
    """chip_smoke.py's edge batches (unsorted rows of up to 40 calls; a
    sorted slab of rows up to 200 calls across the tile edges) on the
    card == the twin, twice the same table; a sorted batch is not sorted
    again."""
    start, length, count, codes, n = chip_smoke.pair_edge_batch(name)
    cols = [torch.from_numpy(a) for a in (start, length, count, codes)]
    want = pairs.pair_counts_add_plain(torch.zeros((n, 4), dtype=torch.int32),
                                       *cols)
    dcols = [c.to(cuda_device) for c in cols]
    if name == "long_rows" and hint is not False:
        def no_sort(*args, **kwargs):
            raise AssertionError("a sorted batch was sorted")
        monkeypatch.setattr(torch, "sort", no_sort)
    for _ in range(2):
        got = pairs.pair_counts_add(
            torch.zeros((n, 4), dtype=torch.int32, device=cuda_device),
            *dcols, is_sorted=hint)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
