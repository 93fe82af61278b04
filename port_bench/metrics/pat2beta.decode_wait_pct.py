"""pat2beta.decode_wait_pct: percent of the traced jobs' wall in the time the
pipeline waits for the next decoded slab (pipeline/pat2beta.py::stream_into,
timings['decode'])."""


def read(run):
    if run.job != "pat2beta":
        return None
    return run.share('decode')
