"""pat2beta.finalize_pct: percent of the traced jobs' wall in saturation, fetch
and the beta's write (timings['saturate_fetch'] + timings['write'])."""


def read(run):
    if run.job != "pat2beta":
        return None
    return run.share('saturate_fetch', 'write')
