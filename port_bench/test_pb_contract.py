"""BENCHMARK.json against the benchmark's contract, and the harness's way
out where there is no card. A cell or metric added later is checked here
with the rest: each name must find its files under port_bench/."""

import json
import os.path as op
import re
import subprocess
import sys

import pytest

HERE = op.dirname(op.abspath(__file__))
ROOT = op.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(op.join(ROOT, "BENCHMARK.json")))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert op.getsize(op.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and \
            _line(c["source"])
        assert c["file"].startswith("port_bench/configs/")
        cfg = json.load(open(op.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        # the plain reference beside it
        assert op.isfile(op.join(ROOT, c["file"][:-len(".json")] + ".py"))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        traffic = json.load(open(op.join(HERE, "workloads",
                                         w["traffic"] + ".json")))
        assert op.isfile(op.join(HERE, "jobs", traffic["job"] + ".py"))
        assert all(v is not None for v in traffic["limits"].values())


def _cells(m):
    return m.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        # each cell it lists reports the metric it moves
        assert set(_cells(m)) <= set(_cells(e2e[m["moves"]])) <= cells
        assert op.isfile(op.join(HERE, "metrics", m["name"] + ".py"))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:  # setup_s, one more end-to-end metric, a per-layer one
        assert sum(w in _cells(m) for m in BENCH["end_to_end"]) >= 2
        assert any(w in _cells(m) for m in BENCH["per_layer"])


def test_no_card_no_result():
    """Without CUDA (or with fewer cards than the cell asks for) the run
    exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "pat2beta.pe150", "--seed", str(2**33),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
