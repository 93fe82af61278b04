"""segment.exact_plan_pct: percent of the traced jobs' wall in the exact
route's host planning (models/segment_exact_device.py::plan_windows,
timings['plan'])."""


def read(run):
    if run.job != "segment":
        return None
    return run.share('plan')
