"""pat2beta.stage_prep_pct: percent of the traced jobs' wall in host
staging's numpy preparation (ops/pileup_v3.py::stage_v3: the split of long
lines, the window clip, the piece split and its stable sort; the program's
span pileup.stage.prep)."""

from port_bench.spans import share


def read(run):
    if run.job != "pat2beta":
        return None
    return share(run, "pileup.stage.prep")
