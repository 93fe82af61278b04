"""pat2beta.h2d_pct: percent of the traced jobs' wall in the upload of staged
batches (staged_from_numpy, timings['h2d'])."""


def read(run):
    if run.job != "pat2beta":
        return None
    return run.share('h2d')
