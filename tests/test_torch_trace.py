"""The port's spans and counters (wgbs_tools_tpu_torch/trace.py): nothing is
recorded and nothing is called while no profiler runs; under a CPU
profiler, pat2beta and segment name each of their layers, nested as the
program nests them, and count their sites and bed rows; the stage timings
dicts keep their keys, and no span synchronises the device."""

import json
import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from test_torch_segment import make_blocky_beta  # noqa: E402
from torch._C._profiler import _ExperimentalConfig  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from wgbs_tools_tpu.formats.beta import save_beta  # noqa: E402
from wgbs_tools_tpu.formats.pat import write_pat  # noqa: E402
from wgbs_tools_tpu_torch import trace  # noqa: E402
from wgbs_tools_tpu_torch.cli import cmd_segment  # noqa: E402
from wgbs_tools_tpu_torch.device import timed  # noqa: E402
from wgbs_tools_tpu_torch.models import segment_exact_device as sed  # noqa
from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

N_SITES = 9000

# (span, the span it must lie inside (or a tuple of them), or None for the
# outermost)
PAT2BETA_SPANS = [
    ("pat2beta.run", None),
    ("pat2beta.setup", "pat2beta.run"),
    ("pat2beta.decode_wait", "pat2beta.run"),
    ("pileup.add", "pat2beta.run"),
    ("pileup.stage", "pileup.add"),
    ("pileup.stage.prep", "pileup.stage"),
    ("pileup.stage.pack", "pileup.stage"),
    ("pileup.stage.place", "pileup.stage"),
    ("pileup.stage.assemble", "pileup.stage"),
    ("pileup.h2d", "pileup.add"),
    ("pileup.kernel", "pileup.add"),
    ("pileup.fold", "pileup.add"),
    ("pileup.saturate_fetch", "pat2beta.run"),
    ("pat2beta.write", "pat2beta.run"),
]
SEGMENT_SPANS = [
    ("segment.run", None),
    ("segment.setup", "segment.run"),
    ("segment.chunks", "segment.run"),
    ("segment.beta_load", "segment.chunks"),
    ("segment.host_chunks", "segment.chunks"),
    ("segment.stitch", "segment.run"),
    ("segment.stitch.reseg", "segment.stitch"),
    ("segment.bed_loci", "segment.run"),
    ("segment.bed_write", "segment.run"),
]
EXACT_SPANS = SEGMENT_SPANS + [
    ("segment.exact.plan", "segment.chunks"),
    ("segment.exact.h2d", "segment.chunks"),
    ("segment.exact.dp", "segment.chunks"),
    ("segment.exact.ks_fetch", "segment.chunks"),
    ("segment.traceback", "segment.chunks"),
]
# fast mode's window batches run in the chunks and in the stitch's patches
FAST_BATCH = ("segment.chunks", "segment.stitch.reseg")
FAST_SPANS = SEGMENT_SPANS + [
    ("segment.fast.prefix", FAST_BATCH),
    ("segment.fast.h2d", FAST_BATCH),
    ("segment.fast.cost", FAST_BATCH),
    ("segment.fast.dp", FAST_BATCH),
    ("segment.fast.mask_fetch", FAST_BATCH),
]
PAT2BETA_KEYS = {"decode", "stage", "h2d", "kernel", "saturate_fetch",
                 "write"}
EXACT_KEYS = {"beta_load", "plan", "h2d", "dp", "ks_fetch", "chunks",
              "stitch"}
FAST_KEYS = {"beta_load", "h2d", "cost", "dp", "mask_fetch", "chunks",
             "stitch"}


class _Genome:
    nr_sites = N_SITES

    def get_nr_sites(self):
        return N_SITES


@pytest.fixture(scope="module")
def pat(tmp_path_factory):
    rng = np.random.default_rng(37)
    frags = random_frags(rng, 6000, N_SITES - 30, max_len=24, h_rate=0.03)
    path = str(tmp_path_factory.mktemp("trace_pat") / "plain.pat.gz")
    write_pat(frags, path)
    return path, frags


@pytest.fixture(scope="module")
def seg_betas(mini_genome, tmp_path_factory):
    """Three blocky betas over the mini genome's sites."""
    n = mini_genome.get_nr_sites()
    d = tmp_path_factory.mktemp("trace_betas")
    rng = np.random.default_rng(11)
    paths = []
    for k in range(3):
        p = str(d / f"s{k}.beta")
        save_beta(p, make_blocky_beta(rng, n, n_blocks=60))
        paths.append(p)
    return paths


def _profiled(fn, tmp_path):
    """Run fn() under a CPU profiler that follows every thread; returns
    (fn's result, [(start, end, name, tid)] of the trace's spans)."""
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
              e["tid"]) for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, spans


def _inside(span, outer):
    eps = 1e-3  # the trace's microseconds carry three decimals
    a, b, _, tid = span
    return any(pa - eps <= a and b <= pb + eps and ptid == tid
               for pa, pb, _, ptid in outer)


def _assert_nested(spans, table):
    """Every span of the table is in the trace, each inside a span of one
    of its parents on the same thread."""
    for name, parents in table:
        mine = [s for s in spans if s[2] == name]
        assert mine, f"no span {name}"
        if parents is None:
            continue
        if isinstance(parents, str):
            parents = (parents,)
        outer = [s for s in spans if s[2] in parents]
        for s in mine:
            assert _inside(s, outer), (name, parents)


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _no_synchronize(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def _route_on_cpu(monkeypatch):
    """CUDA reads as available and the exact device route runs its kernel's
    twin on the CPU (tests/test_torch_segment_exact.py's stand-in)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sed, "resolve_device", lambda d: torch.device("cpu"))


def _segment(paths, out, mode, device, timings=None):
    argv = ["--betas", *paths, "-o", str(out), "--mode", mode, "--device",
            device, "-c", "400", "--max_cpg", "64"]
    assert cmd_segment.main(argv, timings=timings) == 0
    return out


def test_no_profiler_records_nothing(monkeypatch):
    _no_record_function(monkeypatch)
    _no_synchronize(monkeypatch)
    trace.reset_counters()
    assert not trace.on()
    with trace.span("a.b"):
        trace.count("a.count", 5)
    timings = {}
    with timed(timings, "stage", "cpu"):
        pass
    with timed(None, "stage", "cuda"):
        pass
    assert trace.counters() == {} and set(timings) == {"stage"}


def test_span_and_count_under_a_profiler(tmp_path):
    def body():
        with trace.span("outer"):
            with trace.span("inner"):
                trace.count("things", 3)
            trace.count("things", 4)

    trace.count("things", 100)  # no profiler: not counted
    _, spans = _profiled(body, tmp_path)
    _assert_nested(spans, [("outer", None), ("inner", "outer")])
    assert trace.counters() == {"things": 7}
    trace.count("things", 100)
    assert trace.counters() == {"things": 7}


def test_timed_names_its_span_after_the_caller(tmp_path):
    timings = {}

    def body():
        with timed(timings, "stage_x", "cpu"):
            pass
        with timed(None, "stage_y", None, span="layer.named"):
            pass

    _, spans = _profiled(body, tmp_path)
    names = {s[2] for s in spans}
    assert {"test_torch_trace.stage_x", "layer.named"} <= names
    assert set(timings) == {"stage_x"}


def test_timed_adds_nothing_when_the_block_raises():
    timings = {}
    with pytest.raises(KeyError):
        with timed(timings, "stage", "cpu"):
            raise KeyError("x")
    assert timings == {}


def test_pat2beta_spans_nested_and_sites_counted(tmp_path, pat, monkeypatch):
    path, frags = pat
    _no_synchronize(monkeypatch)
    timings = {}
    out, spans = _profiled(lambda: pat2beta(
        path, genome=_Genome(), chunk_bytes=20_000,
        out_path=str(tmp_path / "x.beta"), device="cpu", timings=timings),
        tmp_path)
    _assert_nested(spans, PAT2BETA_SPANS)
    # the lookahead thread decodes in its own span, beside the main thread
    main_tid = next(s[3] for s in spans if s[2] == "pat2beta.run")
    decode = [s for s in spans if s[2] == "pat2beta.decode"]
    assert decode and all(s[3] != main_tid for s in decode)
    assert trace.counters()["pileup.sites"] == int(frags.length.sum())
    assert set(timings) == PAT2BETA_KEYS
    # a span a slab or a stage: several slabs, never one a line
    n_add = sum(s[2] == "pileup.add" for s in spans)
    assert 1 < n_add < 100 and len(spans) < 20 * n_add + 20
    # the beta is the one written without a profiler
    want = pat2beta(path, genome=_Genome(), chunk_bytes=20_000,
                    out_path=str(tmp_path / "y.beta"), device="cpu")
    assert open(out, "rb").read() == open(want, "rb").read()


def test_pat2beta_timings_none_never_synchronizes(tmp_path, pat,
                                                  monkeypatch):
    path, _ = pat
    _no_synchronize(monkeypatch)
    _, spans = _profiled(lambda: pat2beta(
        path, genome=_Genome(), chunk_bytes=20_000,
        out_path=str(tmp_path / "x.beta"), device="cpu"), tmp_path)
    _assert_nested(spans, PAT2BETA_SPANS)


def _bed_lines(path):
    with open(path) as f:
        return sum(1 for _ in f)


@pytest.mark.parametrize("timings", [None, {}], ids=["no_timings",
                                                     "timings"])
def test_segment_exact_device_route_spans(tmp_path, seg_betas, monkeypatch,
                                          timings):
    """Exact mode on the device route (its twin on the CPU, CUDA faked):
    every span nested; with timings=None no synchronize is called, with a
    dict its keys are the route's, the synchronize a no-op here."""
    _route_on_cpu(monkeypatch)
    if timings is None:
        _no_synchronize(monkeypatch)
    else:
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out, spans = _profiled(lambda: _segment(
        seg_betas, tmp_path / "exact.bed", "exact", "cuda", timings),
        tmp_path)
    _assert_nested(spans, EXACT_SPANS)
    rows = _bed_lines(out)
    assert rows > 100 and trace.counters()["segment.bed_rows"] == rows
    if timings is not None:
        assert set(timings) == EXACT_KEYS
    # no span a block: far fewer spans than bed rows
    assert max(Counter(s[2] for s in spans).values()) < rows / 4


def test_segment_fast_spans(tmp_path, seg_betas):
    timings = {}
    out, spans = _profiled(lambda: _segment(
        seg_betas, tmp_path / "fast.bed", "fast", "cpu", timings), tmp_path)
    _assert_nested(spans, FAST_SPANS)
    for parent in FAST_BATCH:
        outer = [s for s in spans if s[2] == parent]
        assert any(_inside(s, outer) for s in spans
                   if s[2] == "segment.fast.dp")
    rows = _bed_lines(out)
    assert trace.counters()["segment.bed_rows"] == rows
    assert set(timings) == FAST_KEYS
    assert max(Counter(s[2] for s in spans).values()) < rows / 4


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_segment_bed_same_under_the_profiler(tmp_path, seg_betas, mode):
    """The profiled command writes the unprofiled command's bytes, and its
    timings keys are the same with and without the profiler."""
    t0, t1 = {}, {}
    want = _segment(seg_betas, tmp_path / "a.bed", mode, "cpu", t0)
    got, _ = _profiled(lambda: _segment(seg_betas, tmp_path / "b.bed", mode,
                                        "cpu", t1), tmp_path)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert set(t0) == set(t1)


def test_span_cost_on_a_small_cell(monkeypatch, capsys):
    """span_cost.py on a small segment.exact cell on the CPU: an untraced
    and a spans-only window, the spans' idle seconds named in full, the
    bed rows counted."""
    import span_cost
    from port_bench import run
    from port_bench.conftest import small_cell

    cell = small_cell("segment.exact", n_sites=12_000, chunk=3_000)
    monkeypatch.setattr(run, "Cell", lambda name: cell)
    env = dict(os.environ)  # the script points the reference dir elsewhere
    try:
        assert span_cost.main(["--workload", "segment.exact", "--seed",
                               str(2**33 + 3), "--seconds", "0.01",
                               "--rounds", "1", "--device", "cpu"]) == 0
    finally:
        os.environ.clear()
        os.environ.update(env)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    off, spans = out["windows"]
    assert off["mode"] == "off" and spans["mode"] == "spans"
    assert len(off["walls"]) == len(spans["walls"]) == 1
    idle = spans["idle_by_span"]
    assert {"segment.bed_write", "segment.setup"} <= set(idle)
    assert sum(idle.values()) == pytest.approx(spans["idle_s"], rel=1e-6)
    assert spans["counters"]["segment.bed_rows"] > 0
    assert 0 <= spans["no_layer_idle_share"] < 0.5
