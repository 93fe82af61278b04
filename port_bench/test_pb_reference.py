"""The plain references against brute-force loops at tiny sizes, and the
segmentation reference against the port's host exact mode."""

import importlib.util
import os
import os.path as op

import numpy as np
import pytest
import torch

from port_bench import gen
from port_bench.conftest import small_cell

HERE = op.dirname(op.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "ref_" + name, op.join(HERE, "configs", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PILE = _load("hg19_wgbs_pileup")
SEG = _load("hg19_segment")


def _frags(rng, n, n_sites, max_len):
    length = rng.integers(1, max_len + 1, n)
    start = np.sort(rng.integers(1, n_sites - max_len, n))
    codes = rng.choice(np.array([0, 1, 2, 3], np.uint8),
                       size=int(length.sum()), p=[0.3, 0.5, 0.05, 0.15])
    return gen.Frags(start=start, length=length,
                     count=rng.integers(1, 40, n), chrom=np.zeros(n, np.int64),
                     codes=codes)


def test_pileup_brute_force():
    rng = np.random.default_rng(5)
    f = _frags(rng, 300, 200, 12)
    want = np.zeros((200, 2), np.int64)
    off = f.offsets()
    for i in range(f.n):
        for j in range(f.length[i]):
            c = f.codes[off[i] + j]
            site = f.start[i] - 1 + j
            if c != 3:
                want[site, 1] += f.count[i]
            if c in (1, 2):
                want[site, 0] += f.count[i]
    assert np.array_equal(PILE.pileup(f, 200), want)
    assert want[:, 1].max() > 255  # saturation is reached
    sat = PILE.beta(f, 200)
    for (m, c), (sm, sc) in zip(want, sat):
        if c > 255:
            assert (sm, sc) == (int(m / c * 255), 255)
        else:
            assert (sm, sc) == (m, c)
    four = PILE.beta(f, 200, bits=4)
    assert four[:, 1].max() == 15 and (four != sat).any()


def _cost_brute(data, k, i, pc):
    """segmentor.cpp's chain, written out with numpy scalars."""
    total = np.float64(0.0)
    for d in range(data.shape[0]):
        nm = np.float32(data[d, k:i + 1, 0].sum())
        nt = np.float32(data[d, k:i + 1, 1].sum())
        if nt == 0:
            continue
        p = np.float32((nm + np.float32(pc)) / (nt + np.float32(2 * pc)))
        ll = np.float32(np.float64(nm) * np.log2(np.float64(p)))
        ll = np.float32(np.float64(ll) + np.float64(nt - nm)
                        * np.log2(1.0 - np.float64(p)))
        total = total + np.float64(ll)
    return total


def _dp_brute(data, loci, max_cpg, max_bp, pc):
    n = data.shape[1]
    W = min(max_cpg, n)
    M = np.full(n + 1, -np.inf)
    M[0] = 0.0
    T = np.zeros(n + 1, np.int64)
    for i in range(n):
        best, arg = -np.inf, -1
        for k in range(max(0, i + 1 - W), i + 1):
            if loci[i] - loci[k] > max_bp:
                continue
            v = M[k] + _cost_brute(data, k, i, pc)
            if v > best:
                best, arg = v, k
        M[i + 1], T[i + 1] = best, arg
    b, i = [n], n
    while i > 0:
        i = T[i]
        b.append(i)
    return np.array(b[::-1])


@pytest.mark.parametrize("case", range(4))
def test_dp_brute_force(case):
    rng = np.random.default_rng(case)
    K, n = 2, 70
    cov = rng.poisson(6, (K, n))
    cov[:, 10:16] = 0  # ties from sites of no coverage
    meth = rng.binomial(cov, np.where(np.arange(n) < 35, 0.1, 0.85))
    data = np.stack([meth, cov], -1).astype(np.uint8)
    loci = np.cumsum(rng.integers(2, 60, n)) + 100
    params = {"max_cpg": [8, 30, 1000, 5][case], "max_bp": [2000, 300, 0,
                                                            150][case],
              "pcount": 15.0}
    max_bp = params["max_bp"] or 1 << 40
    want = _dp_brute(data, loci, params["max_cpg"], max_bp, 15.0)
    params["max_bp"] = max_bp
    seg = SEG.Segmenter(data, loci, [0, n], params)
    # two windows at once: the whole and its second half
    got = seg.dp([(1, n + 1), (36, n + 1)])
    assert np.array_equal(got[0], want + 1)
    half = _dp_brute(data[:, 35:], loci[35:], params["max_cpg"], max_bp, 15.0)
    assert np.array_equal(got[1], half + 36)


def _port_blocks(cell, tmp_path, seed):
    """The port's exact mode on the host (native DP) over the cell's betas,
    and the inputs it read."""
    from port_bench.jobs import segment as job

    work = str(tmp_path)
    os.environ["WGBS_TPU_REFDIR"] = op.join(work, "refs")
    st = job.setup(cell, seed, torch.device("cpu"), work)
    job.run(st, 0, None)
    bed = job.parse_bed(st.outputs[0], st.names)
    return st, bed


def test_segment_reference_is_the_port_exact(tmp_path):
    """The reference (chunks, DP, stitching, bed columns) gives the blocks
    the port's host exact mode writes: the same borders, loci and tiling,
    over chunks of 4,000 sites of three chromosomes."""
    from port_bench.jobs import segment as job

    cell = small_cell("segment.exact", n_sites=24_000, chunk=4_000)
    st, bed = _port_blocks(cell, tmp_path, 31)
    cfg = cell.config
    params = {"chunk_size": 4_000, "max_cpg": 1000, "max_bp": cfg["max_bp"],
              "pcount": cfg["pcount"], "min_cpg": 1}
    s, e = SEG.segment(st.data, st.loci, st.offsets, params)
    assert np.array_equal(bed[3], s) and np.array_equal(bed[4], e)
    c, bs, be = SEG.bed_columns(s, e, st.loci, st.offsets)
    assert np.array_equal(bed[0], c) and np.array_equal(bed[1], bs)
    assert np.array_equal(bed[2], be)
    assert job.compare(bed, s, e, st.loci, st.offsets) == (0, 0, 0.0)
