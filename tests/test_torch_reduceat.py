"""The port's block sums (ops/reduceat.py) and the commands that reach them
(beta_to_blocks, beta_to_table) against the JAX package, tolerance 0:
block_sums' twin against JAX's _reduce_nice, reduce_data_to_blocks on
nice, non-nice, NA, empty and clipped blocks, base != 1, uint16 data and
4 CPU stand-in shards, a block past 2^31 against numpy (where JAX's int32
segment_sum wraps), and each CLI's bytes against the JAX CLI's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from synth import random_beta  # noqa: E402
from wgbs_tools_tpu.formats.beta import save_beta as jax_save_beta  # noqa: E402
from wgbs_tools_tpu.ops import reduceat as jred  # noqa: E402
from wgbs_tools_tpu_torch.ops import reduceat  # noqa: E402
from wgbs_tools_tpu_torch.parallel.mesh import shard_devices  # noqa: E402

N = 6000


def make_blocks(rng, n_blocks, nr_sites, min_len=2, max_len=30):
    """Sorted non-overlapping blocks, as tests/test_frag_ops.py::make_blocks
    draws them (a copy: that module imports the JAX package's oracle
    helpers, which the port's card tests do not need)."""
    starts = np.sort(rng.choice(np.arange(1, nr_sites), size=n_blocks,
                                replace=False))
    lens = rng.integers(min_len, max_len, size=n_blocks)
    ends = starts + lens
    for i in range(1, n_blocks):
        starts[i] = max(starts[i], ends[i - 1])
        ends[i] = max(ends[i], starts[i] + 1)
    return starts.astype(np.int64), ends.astype(np.int64)


def _data(seed, n=N, dtype=np.uint8, max_cov=256):
    d = random_beta(np.random.default_rng(seed), n, max_cov=max_cov)
    return d.astype(dtype)


def _blocks(case, n=N, seed=3):
    """(starts, ends, base) of a test case over an n-row table."""
    rng = np.random.default_rng(seed)
    s, e = make_blocks(rng, 300, n - 40)
    if case == "nice":
        return s, e, 1
    if case == "non_nice":  # every 10th block shifted into its neighbour
        s2, e2 = s.copy(), e.copy()
        s2[1::10], e2[1::10] = s[0:-1:10] + 1, e[0:-1:10] + 3
        return s2, e2, 1
    if case == "unsorted":
        p = rng.permutation(s.shape[0])
        return s[p], e[p], 1
    if case == "na":
        s2, e2 = s.copy(), e.copy()
        s2[::7], e2[::7] = -1, -1
        return s2, e2, 1
    if case == "empty":
        return s[:0], e[:0], 1
    if case == "all_na":
        return np.full(5, -1), np.full(5, -1), 1
    if case == "zero_length":  # s == e and e < s rows
        s2, e2 = s.copy(), e.copy()
        e2[::5] = s2[::5]
        e2[1::9] = s2[1::9] - 2
        return s2, e2, 1
    if case == "clipped":  # before row 0 and past the table's end
        s2, e2 = s.copy(), e.copy()
        s2[0], e2[-1] = 0, n + 500
        s2[-3:], e2[-3:] = n + 10, n + 900
        return s2, e2, 1
    if case == "base":
        return s + 1000, e + 1000, 1100
    raise KeyError(case)


CASES = ("nice", "non_nice", "unsorted", "na", "empty", "all_na",
         "zero_length", "clipped", "base")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("case", CASES)
def test_reduce_data_to_blocks_equals_jax(case, dtype):
    data = _data(1, dtype=dtype, max_cov=256 if dtype == np.uint8 else 9000)
    s, e, base = _blocks(case)
    want = jred.reduce_data_to_blocks(data, s, e, base=base)
    got = reduceat.reduce_data_to_blocks(data, s, e, base=base, device="cpu")
    assert got.dtype == np.int64 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["nice", "non_nice", "na", "clipped"])
def test_reduce_sharded_over_4_stand_ins_equals_jax(case):
    """4 CPU stand-in shards (JAX's _reduce_nice_sharded): each shard sums
    the blocks clipped to its rows; the partials add to JAX's sums."""
    data = _data(2)
    s, e, base = _blocks(case)
    devices = shard_devices("cpu", n_shards=4)
    got = reduceat.reduce_data_to_blocks(data, s, e, base=base,
                                         device=devices)
    assert np.array_equal(got, jred.reduce_data_to_blocks(data, s, e,
                                                          base=base))


def test_twin_equals_jax_reduce_nice():
    """block_sums_plain on [s, e) rows == JAX's segment_sum over per-site
    block ids (_reduce_nice, after _segment_ids)."""
    data = _data(4)
    s, e, _ = _blocks("nice")
    s0, e0 = s - 1, e - 1
    seg = jred._segment_ids(s0, e0, N, s.shape[0])
    want = np.asarray(jred._reduce_nice(data.astype(np.int32), seg,
                                        s.shape[0]))
    before = reduceat.block_sums.launches
    got = reduceat.block_sums(torch.from_numpy(data),
                              torch.from_numpy(np.stack([s0, e0], 1)))
    assert reduceat.block_sums.launches == before  # the CPU takes the twin
    assert np.array_equal(got.numpy(), want)


def test_block_past_2_31_equals_numpy():
    """One block over a 9,000,000-site table at coverage 255: its sum
    passes 2^31. JAX's nice path sums in int32 and wraps; the port sums
    in int64 and equals numpy (ROADMAP.md section 3)."""
    n = 9_000_000
    data = np.full((n, 2), 255, dtype=np.uint8)
    data[::3, 0] = 7
    want = data.sum(axis=0, dtype=np.int64)
    assert want[1] > 2**31
    got = reduceat.reduce_data_to_blocks(data, [1, 5], [n + 1, 9],
                                         device="cpu")
    assert np.array_equal(got[0], want)
    assert np.array_equal(got[1], data[4:8].sum(axis=0, dtype=np.int64))


@pytest.mark.parametrize("name", chip_smoke.BLOCK_EDGE)
def test_block_edge_twin_equals_jax_and_numpy(name):
    """chip_smoke.py's edge batch for block_sums (NA blocks, s == e,
    blocks clipped past the table, uint16 data; the whole-genome block at
    coverage 255 cut to 9,000,000 sites, still past 2^31): the twin ==
    the JAX package's per-block path == numpy."""
    data, s, e = chip_smoke.block_edge_batch(name, n=9_000_000)
    got = reduceat.reduce_data_to_blocks(data, s, e, device="cpu")
    assert np.array_equal(got, jred.reduce_data_to_blocks(data, s, e))
    n = data.shape[0]
    for k in (0, 3, 4, 7, 100):  # whole, clipped, clipped, seeded
        lo = min(max(s[k] - 1, 0), n)
        assert np.array_equal(got[k], data[lo:max(min(e[k] - 1, n), lo)].sum(
            axis=0, dtype=np.int64))
    assert got[1].tolist() == [0, 0] and got[2].tolist() == [0, 0]
    assert name == "uint16" or got[0, 1] > 2**31


def test_block_bounds_clip_as_jax():
    bounds = reduceat.block_bounds([-1, 0, 3, 8, 12], [-1, 2, 2, 20, 13],
                                   base=1, n=10)
    assert bounds.tolist() == [[0, 0], [0, 1], [2, 2], [7, 10], [10, 10]]


def test_block_sums_checks_its_inputs():
    data = torch.zeros((5, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="bounds"):
        reduceat.block_sums(data, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="data"):
        reduceat.block_sums(data[:, 0], torch.zeros((3, 2),
                                                    dtype=torch.int64))


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def betas(tmp_path_factory):
    """Two betas, an lbeta, a .uxm and two blocks beds (nice with an NA row;
    non-nice), written by the JAX package or by hand."""
    d = tmp_path_factory.mktemp("reduce_betas")
    paths = {}
    for k in range(2):
        paths[f"b{k}"] = str(d / f"s{k}.beta")
        jax_save_beta(paths[f"b{k}"], _data(10 + k, max_cov=300))
    paths["lbeta"] = str(d / "deep.lbeta")
    jax_save_beta(paths["lbeta"], _data(12, dtype=np.int64, max_cov=90000))
    s, e, _ = _blocks("nice")
    rows = [f"chr1\t{a * 10}\t{b * 10}\t{a}\t{b}" for a, b in zip(s, e)]
    rows[4] = "chr1\t40\t50\tNA\tNA"
    paths["bed"] = str(d / "blocks.bed")
    with open(paths["bed"], "w") as f:
        f.write("\n".join(rows) + "\n")
    s2, e2, _ = _blocks("non_nice")
    paths["bed_non_nice"] = str(d / "blocks2.bed")
    with open(paths["bed_non_nice"], "w") as f:
        f.write("".join(f"chr2\t{a}\t{b}\t{a}\t{b}\n" for a, b in zip(s2, e2)))
    uxm = np.random.default_rng(13).integers(0, 40, size=(len(rows), 3))
    paths["uxm"] = str(d / "u0.uxm")
    uxm.astype(np.uint8).tofile(paths["uxm"])
    paths["groups"] = str(d / "groups.csv")
    with open(paths["groups"], "w") as f:
        f.write("name,group\ns0,g1\ns1,g1\ndeep,g2\ns0,g2\n")
    return paths


def _both(tmp_path, argv, port_extra=("--device", "cpu")):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    dirs = []
    for who, main, extra in (("j", jax_main, ()), ("t", port_main,
                                                   port_extra)):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        args = [a.replace("{out}", str(d)) for a in argv]
        assert main(args + list(extra)) == 0
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("form", ["bin", "lbeta", "bedGraph", "non_nice",
                                  "lbeta_input"])
def test_cli_beta_to_blocks_equals_jax(tmp_path, betas, form):
    bed = betas["bed_non_nice" if form == "non_nice" else "bed"]
    inputs = ([betas["lbeta"]] if form == "lbeta_input"
              else [betas["b0"], betas["b1"]])
    argv = ["beta_to_blocks"] + inputs + ["-b", bed, "-o", "{out}"]
    argv += {"lbeta": ["--lbeta"], "bedGraph": ["--bedGraph"]}.get(form, [])
    j, t = _both(tmp_path, argv)
    names = sorted(p.name for p in j.iterdir())
    assert names == sorted(p.name for p in t.iterdir())
    assert len(names) == len(inputs) * (2 if form == "bedGraph" else 1)
    for name in names:
        assert (t / name).read_bytes() == (j / name).read_bytes(), name


@pytest.mark.parametrize("form", ["plain", "groups", "uxm", "digits",
                                  "chunked"])
def test_cli_beta_to_table_equals_jax(tmp_path, betas, form):
    inputs = [betas["b0"], betas["b1"], betas["lbeta"]]
    extra = {"groups": ["-g", betas["groups"]],
             "uxm": ["-c", "2"], "digits": ["--digits", "4"],
             "chunked": ["--chunk_size", "37"]}.get(form, [])
    if form == "uxm":
        inputs.append(betas["uxm"])
    argv = ["beta_to_table", betas["bed"], "--betas"] + inputs + [
        "-o", "{out}/table.tsv"] + extra
    j, t = _both(tmp_path, argv)
    want = (j / "table.tsv").read_bytes()
    assert want.count(b"\n") == 301
    assert (t / "table.tsv").read_bytes() == want


def test_cli_asks_for_cuda(tmp_path, betas, monkeypatch):
    """Without --device the commands ask for CUDA and raise without it."""
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["beta_to_blocks", betas["b0"], "-b", betas["bed"], "-o",
                   str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["beta_to_table", betas["bed"], "--betas", betas["b0"]])


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("case", CASES)
def test_cuda_block_sums_equals_twin(cuda_device, case, dtype):
    data = _data(5, dtype=dtype, max_cov=256 if dtype == np.uint8 else 9000)
    s, e, base = _blocks(case)
    bounds = torch.from_numpy(reduceat.block_bounds(s, e, base, N))
    d = torch.from_numpy(data)
    before = reduceat.block_sums.launches
    got = reduceat.block_sums(d.to(cuda_device), bounds.to(cuda_device))
    torch.cuda.synchronize()
    assert reduceat.block_sums.launches == before + (bounds.shape[0] > 0)
    assert torch.equal(got.cpu(), reduceat.block_sums_plain(d, bounds))
    assert np.array_equal(
        reduceat.reduce_data_to_blocks(data, s, e, base=base,
                                       device=cuda_device),
        jred.reduce_data_to_blocks(data, s, e, base=base))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("name", chip_smoke.BLOCK_EDGE)
def test_cuda_block_edge_equals_twin(cuda_device, name, offset):
    """chip_smoke.py's edge batches (cut to 2,000,000 sites: the
    whole-genome block's pieces, unsorted, overlapping, over-budget blocks
    and runs of both bodies) on the card == the twin, with the table's
    first row `offset` rows into its allocation (the staged hull's and
    the pieces' 16-byte ends move)."""
    data, s, e = chip_smoke.block_edge_batch(name, n=2_000_000)
    bounds = torch.from_numpy(reduceat.block_bounds(s, e, 1, data.shape[0]))
    d = torch.from_numpy(data)
    held = torch.zeros((data.shape[0] + offset, 2), dtype=d.dtype,
                       device=cuda_device)
    held[offset:] = d.to(cuda_device)
    got = reduceat.block_sums(held[offset:], bounds.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), reduceat.block_sums_plain(d, bounds))
