"""The port's scatter pileup, accumulator (every backend and v3 form),
pileup_frags and device saturation against the JAX package (pileup_xla,
PileupAccumulator, pileup_frags, trim_to_uint), exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.formats.beta import trim_to_uint  # noqa: E402
from wgbs_tools_tpu.ops import pileup as jax_pileup  # noqa: E402
from wgbs_tools_tpu_torch.ops import pileup  # noqa: E402


@pytest.mark.parametrize("ws,wl,batch", [(1, 5000, 1 << 20),
                                         (1000, 500, 1 << 20),
                                         (1, 5000, 333)])
def test_pileup_torch_equals_pileup_xla(ws, wl, batch):
    f = random_frags(np.random.default_rng(wl + batch), 1500, 5000,
                     max_len=14, h_rate=0.1, max_count=400)
    want = jax_pileup.pileup_xla(f.start, f.length, f.count, f.codes, ws, wl)
    got = pileup.pileup_torch(f.start, f.length, f.count, f.codes, ws, wl,
                              "cpu", batch=batch)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


FORMS = {"cuda_split": dict(fused=False), "cuda_lane": dict(vals=False),
         "cuda_tiled": dict(grid="tiled")}


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_split",
                                     "native", "cuda_lane", "cuda_tiled",
                                     "cuda_v2", "cuda_v1"])
def test_accumulator_equals_jax(backend):
    """Streaming batches (one of them unsorted) into the port's accumulator
    on the CPU == the JAX accumulator on the xla backend; the kernel
    backends run their staging and the kernels' twins here: "cuda" (v3;
    "cuda_split" with split value planes, fused=False; "cuda_lane" the
    lane-count form, vals=False; "cuda_tiled" the tiled grid), "cuda_v2"
    and "cuda_v1"."""
    forms = FORMS.get(backend, {})
    if backend in FORMS:
        backend = "cuda"
    if backend == "native" and oracle_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(17)
    f = random_frags(rng, 12_000, 40_000, max_len=20, max_count=9)
    win = (1, 40_017)
    ref = jax_pileup.PileupAccumulator(win, backend="xla",
                                       device_total=False)
    acc = pileup.PileupAccumulator(win, "cpu", backend=backend, **forms)
    batches = [f.take(slice(lo, lo + 2_500))
               for lo in range(0, f.nr_frags, 2_500)]
    batches.append(f.take(rng.permutation(f.nr_frags)[:1_000]))
    for b in batches:
        ref.add(b)
        acc.add(b)
    assert np.array_equal(acc.result(), ref.result())
    for lbeta in (False, True):
        got, want = acc.finalize(lbeta), ref.finalize(lbeta)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_accumulator_timings_and_backends():
    timings = {}
    acc = pileup.PileupAccumulator((1, 3001), "cpu", timings=timings)
    acc.add(random_frags(np.random.default_rng(2), 500, 3000))
    acc.finalize()
    assert set(timings) == {"stage", "h2d", "kernel", "saturate_fetch"}
    with pytest.raises(ValueError, match="backend"):
        pileup.PileupAccumulator((1, 10), "cpu", backend="xla")
    # the plain backends never stand in for the kernels on the card
    for backend in ("torch", "native"):
        with pytest.raises(ValueError, match="host only"):
            pileup.PileupAccumulator((1, 10), "cuda", backend=backend)
    # the v3 form keywords belong to the "cuda" backend
    for backend in ("cuda_v2", "cuda_v1", "torch"):
        with pytest.raises(ValueError, match="form keywords"):
            pileup.PileupAccumulator((1, 10), "cpu", backend=backend,
                                     vals=False)
    with pytest.raises(ValueError, match="grid"):
        pileup.PileupAccumulator((1, 10), "cpu", grid="diagonal")


@pytest.mark.parametrize("backend,jax_backend,forms", [
    ("cuda", "pallas3", {}),
    ("cuda", "pallas3", dict(vals=False)),
    ("cuda", "pallas3", dict(grid="tiled")),
    ("cuda_v2", "pallas2", {}),
    ("cuda_v1", "pallas", {}),
    ("torch", "xla", {})])
def test_pileup_frags_equals_jax(monkeypatch, backend, jax_backend, forms):
    """The port's pileup_frags == the JAX package's, backend for backend,
    on a batch with fragments on both sides of the window; the JAX v3
    forms are picked with its switches, the port's with keywords."""
    if backend.startswith("cuda") and oracle_lib() is None:
        pytest.skip("native library unavailable")
    if forms.get("vals") is False:
        monkeypatch.setenv("WGBS_TPU_V3_VALS", "0")
    if forms.get("grid") == "tiled":
        monkeypatch.setenv("WGBS_TPU_PILEUP_V3_GRID", "tiled")
    f = random_frags(np.random.default_rng(23), 2500, 6000, max_len=18,
                     h_rate=0.05)
    kw = {} if jax_backend == "xla" else dict(interpret=True)
    want = jax_pileup.pileup_frags(f, (1500, 4500), backend=jax_backend,
                                   **kw)
    got = pileup.pileup_frags(f, (1500, 4500), backend=backend,
                              device="cpu", **forms)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _counts(rng):
    counts = np.zeros((2048, 2), np.int64)
    counts[:, 1] = rng.integers(0, 5000, 2048)
    counts[:, 0] = (counts[:, 1] * rng.random(2048)).astype(np.int64)
    counts[0] = [300, 765]  # meth*255/cov exactly 100
    counts[1] = [2, 510]    # exactly 1
    counts[2] = [255, 256]
    counts[3] = [0, 0]
    counts[4] = [256, 256]
    return counts


@pytest.mark.parametrize("lbeta,mult,cap", [(False, 1, 1 << 20),
                                            (True, 37, 1 << 20),
                                            (False, 1, 4),
                                            (True, 37, 4)])
def test_saturate_device_counts_equals_trim_to_uint(lbeta, mult, cap):
    """Rows with cov > 255 (or > 65535 for lbeta) re-saturate on the host;
    a cap below the overflow count takes the exact full-table pass."""
    counts = _counts(np.random.default_rng(5)) * mult
    n_big = int((counts[:, 1] > (65535 if lbeta else 255)).sum())
    assert n_big > 0 and (cap > n_big or cap < n_big)
    got = pileup.saturate_device_counts(
        torch.from_numpy(counts.astype(np.int32)), lbeta, cap=cap)
    want = trim_to_uint(counts, lbeta)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_fetch_chunked_edges():
    x = torch.arange(1003 * 2, dtype=torch.int32).reshape(1003, 2)
    for mb in (8, 128, 4096, 1 << 20):
        assert np.array_equal(pileup.fetch_chunked(x, max_bytes=mb),
                              x.numpy())
    u = torch.tensor([[1, 65535]], dtype=torch.int32).to(torch.uint16)
    assert pileup.fetch_chunked(u).dtype == np.uint16
