"""The port's site-sharded pileup (parallel/sharded.py::ShardedPileupV3 over
parallel/mesh.py::shard_devices) equals the JAX package's ShardedPileupV3
on an 8-device CPU mesh (Pallas in interpret mode), exactly, for raw counts
and saturated betas; sharded pat2beta writes the JAX package's bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.parallel.mesh import make_mesh  # noqa: E402
from wgbs_tools_tpu.parallel.sharded import (  # noqa: E402
    ShardedPileupV3 as JaxShardedPileupV3,
)
from wgbs_tools_tpu_torch.ops import pileup_v3  # noqa: E402
from wgbs_tools_tpu_torch.ops.pileup import PileupAccumulator  # noqa: E402
from wgbs_tools_tpu_torch.parallel.mesh import shard_devices  # noqa: E402
from wgbs_tools_tpu_torch.parallel.sharded import ShardedPileupV3  # noqa: E402
from wgbs_tools_tpu_torch.pipeline import pat2beta as port_pat2beta  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native packer unavailable")

# (n_sites, random_frags kwargs, batch bounds); fragments sorted + collapsed
CASES = {
    # streamed in uneven batches
    "streamed": (40000, dict(nr_frags=5000, nr_sites=40000 - 50, max_len=18),
                 [0, 700, 1100, 2500, None]),
    # n not divisible by the shard count: the last shard is short
    "uneven_tail": (40000 - 1234, dict(nr_frags=3000, nr_sites=40000 - 1264,
                                       max_len=12), [0, None]),
    # counts >= 256: the classic kernel plus add_ on every shard
    "counts_3000": (30000, dict(nr_frags=2000, nr_sites=30000 - 40,
                                max_len=40, max_count=3000), [0, 900, None]),
    # every fragment in the first quarter: the later shards get no batch
    "idle_shards": (24000, dict(nr_frags=800, nr_sites=24000 // 4 - 20,
                                max_len=10), [0, 300, None]),
}


def _frags(name):
    n, kw, bounds = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 61)
    f = random_frags(rng, **kw).sort().collapse()
    bounds = [f.nr_frags if b is None else b for b in bounds]
    return n, [f.take(np.arange(a, b)) for a, b in zip(bounds[:-1],
                                                      bounds[1:])]


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's ShardedPileupV3 (8 CPU devices, pallas3) on each
    case: (result, finalize(False), finalize(True))."""
    out = {}
    for name in CASES:
        n, batches = _frags(name)
        acc = JaxShardedPileupV3(make_mesh(8, samples_axis=1), (1, n + 1),
                                 backend="pallas3")
        for b in batches:
            acc.add(b)
        out[name] = (acc.result(), acc.finalize(False), acc.finalize(True))
    return out


@pytest.mark.parametrize("n_shards,fused", [(1, True), (4, True), (8, True),
                                            (3, False), (8, False)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_equals_jax(jax_results, name, n_shards, fused):
    n, batches = _frags(name)
    acc = ShardedPileupV3(shard_devices("cpu", n_shards=n_shards), (1, n + 1),
                          fused=fused)
    assert acc.S * n_shards >= n and len(acc.totals) == n_shards
    for b in batches:
        acc.add(b)
    res, beta, lbeta = jax_results[name]
    got = acc.result()
    assert got.dtype == np.int64 and got.shape == (n, 2)
    assert np.array_equal(got, np.asarray(res))
    for lb, want in ((False, beta), (True, lbeta)):
        fin = acc.finalize(lb)
        assert fin.dtype == want.dtype and np.array_equal(fin, want)
    assert acc.coverage() == int(np.asarray(res)[:, 1].sum())
    if name == "idle_shards" and n_shards >= 4:
        # no fragment reaches the last shards: their totals stay zero
        assert not acc.totals[-1].any()


def test_sharded_routes_batches_to_kernels(monkeypatch):
    """Value-plane batches go to flat_vals_add (one call per shard hit,
    in place), classic batches to call_staged + add_."""
    calls = []
    real_add, real_call = pileup_v3.flat_vals_add, pileup_v3.call_staged
    import wgbs_tools_tpu_torch.parallel.sharded as sharded

    monkeypatch.setattr(sharded, "flat_vals_add", lambda total, st, wl: (
        calls.append(("add", st.form)), real_add(total, st, wl))[1])
    monkeypatch.setattr(sharded, "call_staged", lambda st, wl: (
        calls.append(("call", [s.form for s in st])), real_call(st, wl))[1])
    n, batches = _frags("counts_3000")
    acc = ShardedPileupV3(shard_devices("cpu", n_shards=2), (1, n + 1),
                          fused=False)
    acc.add(batches[0])
    assert calls and all(c[0] == "call" for c in calls)
    calls.clear()
    n, batches = _frags("streamed")
    acc = ShardedPileupV3(shard_devices("cpu", n_shards=2), (1, n + 1),
                          fused=False)
    acc.add(batches[1])  # ~400 fragments around site 9,000: shard 0 only
    assert calls == [("add", "vals_split")]


def test_shard_devices_and_routing(monkeypatch):
    assert shard_devices("cpu") == [torch.device("cpu")]
    assert shard_devices("cpu", n_shards=3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="n_shards"):
        shard_devices("cpu", n_shards=0)
    window = (1, 1001)
    acc = port_pat2beta._accumulator(window, "cpu", "cuda", None, None, None)
    assert isinstance(acc, PileupAccumulator)
    acc = port_pat2beta._accumulator(window, "cpu", "cuda", None, True, None)
    assert isinstance(acc, ShardedPileupV3) and len(acc.devices) == 1
    acc = port_pat2beta._accumulator(window, "cpu", "cuda", None, None,
                                     shard_devices("cpu", n_shards=4))
    assert isinstance(acc, ShardedPileupV3) and len(acc.devices) == 4
    with pytest.raises(ValueError, match="contradicts"):
        port_pat2beta._accumulator(window, "cpu", "cuda", None, False,
                                   [torch.device("cpu")])
    with pytest.raises(ValueError, match="sharded path runs the kernels"):
        port_pat2beta._accumulator(window, "cpu", "torch", None, True, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_devices("cuda")


@pytest.mark.parametrize("lbeta", [False, True])
def test_pat2beta_sharded_bytes_equal_jax(tmp_path, mini_genome, lbeta):
    """pat2beta over 4 site shards (CPU) writes the bytes of the JAX
    package's sharded pat2beta; the timings cover the sharded stages."""
    from wgbs_tools_tpu.formats.pat import write_pat
    from wgbs_tools_tpu.pipeline.pat2beta import pat2beta as jax_pat2beta

    nr = mini_genome.index.nr_sites
    frags = random_frags(np.random.default_rng(71), 4000, nr - 40,
                         max_len=16, max_count=400 if lbeta else 3)
    pat = str(tmp_path / "s.pat.gz")
    write_pat(frags.sort().collapse(), pat)
    want = jax_pat2beta(pat, genome=mini_genome, lbeta=lbeta, sharded=True,
                        out_path=str(tmp_path / "jax.beta"),
                        chunk_bytes=1 << 16)
    timings = {}
    got = port_pat2beta.pat2beta(
        pat, genome=mini_genome, lbeta=lbeta, device="cpu",
        devices=shard_devices("cpu", n_shards=4),
        out_path=str(tmp_path / "port.beta"), chunk_bytes=1 << 16,
        timings=timings)
    data = open(got, "rb").read()
    assert len(data) == nr * 2 * (2 if lbeta else 1)
    assert data == open(want, "rb").read()
    assert set(timings) == {"decode", "stage", "h2d", "kernel",
                            "saturate_fetch", "write"}
    counts = port_pat2beta.pat2beta_counts(pat, nr, device="cpu",
                                           sharded=True)
    assert counts.dtype == np.int64 and counts.shape == (nr, 2)
