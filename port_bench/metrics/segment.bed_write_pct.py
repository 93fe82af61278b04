"""segment.bed_write_pct: percent of the traced jobs' wall in the bed's write
(cli/cmd_segment.py::main: a line a block, the close and the optional
index; the program's span segment.bed_write)."""

from port_bench.spans import share


def read(run):
    if run.job != "segment":
        return None
    return share(run, "segment.bed_write")
