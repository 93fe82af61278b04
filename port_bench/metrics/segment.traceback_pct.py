"""segment.traceback_pct: percent of the traced jobs' wall in the exact
route's traceback of each chunk's borders on the host
(models/segment.py::segment_chunks, the program's span
segment.traceback)."""

from port_bench.spans import share


def read(run):
    if run.job != "segment":
        return None
    return share(run, "segment.traceback")
