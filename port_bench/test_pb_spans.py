"""The readers of the program's own spans and counters
(metrics/segment.bed_write_pct.py, segment.bed_rows_per_s.py,
segment.traceback_pct.py, pat2beta.stage_prep_pct.py,
pat2beta.stage_sites_per_s.py) on a hand-made Chrome trace, with counters
set through wgbs_tools_tpu_torch.trace under a CPU profiler: each gives
its value in its cells and None elsewhere, or where its span or counter
is absent. A traced CPU run of each cell reports its new metrics (but the
traceback of exact mode's device route, which the CPU does not take)."""

import json
import os.path as op

import pytest

from port_bench import run
from port_bench.conftest import small_cell
from port_bench.trace_io import Trace

NEW = {
    "segment.bed_write_pct": ["segment.exact", "segment.fast"],
    "segment.bed_rows_per_s": ["segment.exact", "segment.fast"],
    "segment.traceback_pct": ["segment.exact"],
    "pat2beta.stage_prep_pct": ["pat2beta.pe150", "pat2beta.ont_long"],
    "pat2beta.stage_sites_per_s": ["pat2beta.pe150", "pat2beta.ont_long"],
}


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _trace(tmp_path, spans):
    ev = [_span("bench.window", 0, 1_000_000)] + spans
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


# two jobs of 400 ms: beds written in 100 + 60 ms, tracebacks of 30 + 10
# ms, staging of 200 + 100 ms with its prep 50 + 30 ms; the same spans on
# another thread count for nothing
SPANS = [
    _span("segment.bed_write", 300_000, 100_000),
    _span("segment.bed_write", 700_000, 60_000),
    _span("segment.traceback", 100_000, 30_000),
    _span("segment.traceback", 500_000, 10_000),
    _span("pileup.stage", 0, 200_000),
    _span("pileup.stage.prep", 0, 50_000),
    _span("pileup.stage", 400_000, 100_000),
    _span("pileup.stage.prep", 400_000, 30_000),
    _span("segment.bed_write", 0, 900_000, tid=2),
    _span("pileup.stage", 0, 900_000, tid=2),
]


def _reader(name):
    return run.load_file(op.join(op.dirname(op.abspath(__file__)),
                                 "metrics", name + ".py"),
                         "port_bench_metric_" + name)


def _info(cell_name, trace):
    cell = run.Cell(cell_name)
    return run.RunInfo(cell, None, [0.4, 0.4], {}, trace)


def _counted(counts):
    """The program's counters set to `counts` through trace.count under a
    CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from wgbs_tools_tpu_torch import trace

    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for k, v in counts.items():
            trace.count(k, v)
    assert trace.counters() == counts


WANT = {
    "segment.bed_write_pct": 100.0 * 0.16 / 0.8,
    "segment.bed_rows_per_s": 4_000_000 / 0.16,
    "segment.traceback_pct": 100.0 * 0.04 / 0.8,
    "pat2beta.stage_prep_pct": 100.0 * 0.08 / 0.8,
    "pat2beta.stage_sites_per_s": 30_000_000 / 0.3,
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_in_its_cells(tmp_path, name):
    _counted({"segment.bed_rows": 4_000_000, "pileup.sites": 30_000_000})
    tr = _trace(tmp_path, SPANS)
    reader = _reader(name)
    for cell in (w["name"] for w in run.Cell(NEW[name][0]).bench[
            "workloads"]):
        got = reader.read(_info(cell, tr))
        if cell.split(".")[0] == NEW[name][0].split(".")[0]:
            assert got == pytest.approx(WANT[name]), cell
        else:
            assert got is None, cell


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_none_without_span_or_counter(tmp_path, name):
    _counted({})
    for spans in ([], SPANS):
        got = _reader(name).read(_info(NEW[name][0], _trace(tmp_path,
                                                            spans)))
        if spans and name.endswith("_pct"):
            assert got is not None
        else:
            assert got is None


def test_entries_list_their_cells():
    bench = run.Cell("segment.exact").bench
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, cells in NEW.items():
        assert entries[name]["workloads"] == cells
    # appended after the accepted entries
    assert [m["name"] for m in bench["per_layer"]][-len(NEW):] == list(NEW)


@pytest.mark.parametrize("name", ["pat2beta.pe150", "segment.exact",
                                  "segment.fast", "pat2beta.ont_long"])
def test_traced_cpu_run_reports_the_new_metrics(name):
    from wgbs_tools_tpu_torch import trace

    trace.reset_counters()
    cell = small_cell(name, n_sites=12_000, frags=3_000, chunk=3_000)
    r = run.run_cell(cell, 2**33 + 7, 0.01, trace=True, device="cpu")
    assert r["correct"]
    # the CPU runs exact mode's host DP, which has no device route's
    # traceback
    want = {m for m, cells in NEW.items() if name in cells} - {
        "segment.traceback_pct"}
    assert want <= set(r["metrics"])
    for m in want:
        assert r["metrics"][m]["value"] > 0
