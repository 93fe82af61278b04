"""The roofline's work counts: taken from the pat lines and the loci, so the
program's staging form or kernel choice cannot move them."""

import numpy as np

from port_bench import gen, work
from port_bench.conftest import small_cell


def _lines(frags=4_000):
    cell = small_cell("pat2beta.pe150", n_sites=40_000, frags=frags)
    g = gen.make_genome(cell.config["genome"], 3, "cpu")
    lv = gen.block_levels(g, cell.config["methylation"], 3, "cpu")[0]
    return g, gen.make_frags(g, lv, {**cell.traffic, "depth": 30}, 3, "cpu")


def _nbytes(x):
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return sum(_nbytes(v) for v in vars(x).values()) \
        if hasattr(x, "__dict__") else 0


def test_pileup_work_ignores_staging(tmp_path):
    """v3 and v1 staging of the same lines stage different bytes; the count
    is one number, whether taken from the drawn lines or from the pat the
    port parses back."""
    from wgbs_tools_tpu_torch.formats.pat import read_pat
    from wgbs_tools_tpu_torch.ops.pileup_v1 import stage_v1
    from wgbs_tools_tpu_torch.ops.pileup_v3 import stage_v3

    g, f = _lines()
    path = gen.write_pat_gz(str(tmp_path / "w.pat.gz"), f, g.names, "cpu",
                            threads=1)
    pf = read_pat(path)
    lo = int(pf.start.min())
    span = int((pf.start + pf.length).max()) - lo
    args = (pf.start, pf.length, pf.count, pf.codes, lo, span)
    v3, v1 = _nbytes(stage_v3(*args)), _nbytes(stage_v1(*args))
    assert v3 != v1 and v3 > 0 and v1 > 0
    again = gen.Frags(start=pf.start.astype(np.int64),
                      length=pf.length.astype(np.int64),
                      count=pf.count.astype(np.int64),
                      chrom=np.zeros(pf.nr_frags, np.int64),
                      codes=np.concatenate([pf.codes[i, :n] for i, n in
                                            enumerate(pf.length)]))
    assert work.pileup_work(again) == work.pileup_work(f)


def test_pileup_work_by_hand():
    f = gen.Frags(start=np.array([5, 7]), length=np.array([3, 4]),
                  count=np.array([1, 9]), chrom=np.zeros(2, np.int64),
                  codes=np.array([1, 3, 0, 0, 1, 1, 3], np.uint8))
    # 2 lines x 12 bytes + 7 code bytes + sites 5..10 (6) x 8 bytes written
    assert work.pileup_work(f) == (24 + 7 + 48, 2 * 5)


def test_band_cells_brute_force():
    rng = np.random.default_rng(0)
    loci = np.concatenate([np.cumsum(rng.integers(2, 80, 300)),
                           np.cumsum(rng.integers(2, 80, 200))])
    offsets = [0, 300, 500]
    windows = [(1, 121), (121, 301), (301, 302), (302, 501)]
    want = 0
    for s, e in windows:
        n = e - s
        if n <= 1:
            continue
        lo = loci[s - 1:e - 1]
        want += sum(1 for i in range(n) for k in range(n)
                    if 0 <= i - k < min(50, n) and lo[i] - lo[k] <= 700)
    assert work.band_cells(loci, offsets, windows, 50, 700) == want


def test_bound():
    assert work.bound_s(3.35e12, 0, work.FP64_FLOPS) == 1.0
    assert work.bound_s(0, 34e12, work.FP64_FLOPS) == 1.0
    assert abs(work.INT32_OPS - 16.72704e12) < 1e6
