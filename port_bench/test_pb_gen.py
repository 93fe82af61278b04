"""The generator: the same seed gives the same inputs, and the inputs have
the spans, depth, calls and counts that the configuration and traffic
files state."""

import numpy as np
import pytest
import torch

from port_bench import gen
from port_bench.conftest import small_cell

SEED = 2**31 + 77  # past 32 signed bits, as the driver's seeds are


def _inputs(name, seed, n_sites=60_000, frags=60_000):
    cell = small_cell(name, n_sites=n_sites, frags=frags)
    g = gen.make_genome(cell.config["genome"], seed, "cpu")
    lv = gen.block_levels(g, cell.config["methylation"], seed, "cpu")[0]
    f = gen.make_frags(g, lv, {**cell.traffic, "depth": cell.config["depth"]},
                       seed, "cpu")
    return cell, g, f


@pytest.mark.parametrize("name", ["pat2beta.pe150", "pat2beta.ont_long"])
def test_same_seed_same_lines(name):
    _, g1, f1 = _inputs(name, SEED, frags=5_000)
    _, g2, f2 = _inputs(name, SEED, frags=5_000)
    _, g3, f3 = _inputs(name, SEED + 1, frags=5_000)
    assert torch.equal(g1.loci, g2.loci) and not torch.equal(g1.loci, g3.loci)
    for k in ("start", "length", "count", "chrom", "codes"):
        assert np.array_equal(getattr(f1, k), getattr(f2, k))
    assert not np.array_equal(f1.start, f3.start)
    names = g1.names
    assert gen.pat_text(f1, names, 0, f1.n, "cpu") == gen.pat_text(
        f2, names, 0, f2.n, "cpu")


def test_genome_layout():
    cell = small_cell("segment.exact", n_sites=200_000)
    spec = cell.config["genome"]
    g = gen.make_genome(spec, SEED, "cpu")
    assert g.n_sites == 200_000
    loci = g.loci.numpy()
    for c, (a, b) in enumerate(zip(g.offsets[:-1], g.offsets[1:])):
        gaps = np.diff(loci[a:b])
        assert (gaps >= 2).all()  # a CpG never overlaps the next
        assert loci[b - 1] < g.sizes[c]
    gaps = np.concatenate([np.diff(loci[a:b]) for a, b in
                           zip(g.offsets[:-1], g.offsets[1:])])
    assert 95 < gaps.mean() < 120  # ~110 bp over all sites
    isl = g.island.numpy()[1:][np.diff(loci) > 0]
    assert 0.07 < g.island.float().mean() < 0.12
    assert gaps[isl[: gaps.size]].mean() < 15


def test_pe150_lines():
    cell, g, f = _inputs("pat2beta.pe150", SEED)
    t = cell.traffic
    assert f.n == t["frags"]
    assert (np.diff(f.start) >= 0).all()  # pat order
    off = f.offsets()
    # a line starts and ends with a call and stays in its chromosome
    assert (f.codes[off[:-1]] != gen.CODE_DOT).all()
    assert (f.codes[off[1:] - 1] != gen.CODE_DOT).all()
    last = f.start + f.length - 1
    assert (last <= g.offsets[f.chrom + 1]).all()
    assert (f.start > g.offsets[f.chrom]).all()
    # an insert of <= 600 bp holds at most ~600 / 2 sites; ~4 a line
    assert 2.5 < f.length.mean() < 6 and f.length.max() <= 300
    assert (f.count >= 1).all() and 0.5 < (f.count == 1).mean() < 1
    dots = (f.codes == gen.CODE_DOT).mean()
    assert t["dot_share"] < dots < 0.2  # 1 %, and unread insert middles
    cov = cell.reference.pileup(f, g.n_sites)[:, 1]
    inner = cov[f.start.min() + 200: f.start.max() - 200]
    assert abs(inner.mean() / cell.config["depth"] - 0.9) < 0.15


def test_ont_lines():
    cell, g, f = _inputs("pat2beta.ont_long", SEED, n_sites=200_000,
                         frags=3_000)
    t = cell.traffic
    assert f.n == t["frags"] and (f.count == 1).all()
    assert 70 < np.median(f.length) < 110  # median 100, trimmed and cut
    assert f.length.max() <= t["span_max_sites"]
    assert abs((f.codes == gen.CODE_DOT).mean() - t["dot_share"]) < 0.01
    cov = cell.reference.pileup(f, g.n_sites)[:, 1]
    inner = cov[f.start.min() + 2000: f.start.max() - 2000]
    assert abs(inner.mean() / cell.config["depth"] - 1) < 0.15


def test_pat_text_parses_back(tmp_path):
    """The port's own parser reads the written pat.gz back to the lines."""
    from wgbs_tools_tpu_torch.formats.pat import read_pat

    cell, g, f = _inputs("pat2beta.pe150", SEED, frags=20_000)
    path = gen.write_pat_gz(str(tmp_path / "x.pat.gz"), f, g.names, "cpu",
                            lines_per_slab=7_000, threads=2)
    got = read_pat(path)
    assert np.array_equal(got.start, f.start)
    assert np.array_equal(got.length, f.length)
    assert np.array_equal(got.count, f.count)
    off = f.offsets()
    rows = np.concatenate([got.codes[i, : f.length[i]] for i in range(f.n)])
    assert np.array_equal(rows, f.codes)
    assert [got.chrom_names[c] for c in got.chrom_id[:3]] == [
        g.names[c] for c in f.chrom[:3]]
    assert off[-1] == f.codes.size


def test_betas():
    cell = small_cell("segment.exact", n_sites=100_000)
    cfg = cell.config
    g = gen.make_genome(cfg["genome"], SEED, "cpu")
    lv = gen.block_levels(g, cfg["methylation"], SEED, "cpu",
                          n_tissues=cfg["n_betas"])
    b = gen.make_betas(g, lv, cfg, SEED, "cpu")
    b2 = gen.make_betas(g, lv, cfg, SEED, "cpu")
    assert torch.equal(b, b2)
    assert b.shape == (3, 100_000, 2) and b.dtype == torch.uint8
    m, c = b[..., 0].long(), b[..., 1].long()
    assert (m <= c).all()
    assert abs(c.float().mean() - cfg["depth"]) < 0.5
    # tissues differ on the differential blocks only
    same = (lv[0] == lv[1]).float().mean()
    assert 0.7 < same < 0.9


def test_saturate_uint8():
    meth = torch.tensor([10, 300, 0, 255])
    cov = torch.tensor([20, 600, 256, 255])
    got = gen.saturate_uint8(meth, cov)
    assert got.tolist() == [[10, 20], [127, 255], [0, 255], [255, 255]]
