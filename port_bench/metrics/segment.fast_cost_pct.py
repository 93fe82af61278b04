"""segment.fast_cost_pct: percent of the traced jobs' wall in fast mode's cost
build (models/segment.py::_cost_fast, timings['cost'])."""


def read(run):
    if run.job != "segment":
        return None
    return run.share('cost')
