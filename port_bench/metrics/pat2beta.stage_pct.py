"""pat2beta.stage_pct: percent of the traced jobs' wall in host staging
(ops/pileup_v3.py::stage_v3, timings['stage'])."""


def read(run):
    if run.job != "pat2beta":
        return None
    return run.share('stage')
