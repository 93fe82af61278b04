"""segment.fast_dp_pct: percent of the traced jobs' wall in fast mode's DP
(models/segment.py::_dp_fast_blocked with csrc/maxplus.cu, the border mask
and its packing: timings['dp'] of a run that has fast mode's
timings['cost']; exact mode's timings['dp'] is its kernel's, not this)."""


def read(run):
    if run.job != "segment" or "cost" not in run.timings:
        return None
    return run.share("dp")
