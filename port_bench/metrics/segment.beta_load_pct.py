"""segment.beta_load_pct: percent of the traced jobs' wall in loading the
chunks' betas (models/segment.py::segment_chunks, timings['beta_load'])."""


def read(run):
    if run.job != "segment":
        return None
    return run.share('beta_load')
