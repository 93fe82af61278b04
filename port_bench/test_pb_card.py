"""Each cell, run through BENCHMARK.json's command on the card: one short
run whose result line says `correct`. Skips without a CUDA device."""

import json
import os.path as op
import subprocess
import sys

import pytest

ROOT = op.dirname(op.dirname(op.abspath(__file__)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pat2beta.pe150", "segment.exact",
                                  "segment.fast", "pat2beta.ont_long"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(cuda, name, trace):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          name, "--seed", str(2**32 + 17), "--seconds", "1",
                          "--trace", str(trace)], capture_output=True,
                         text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]
