"""segment.bed_rows_per_s: bed lines written a second of the bed's write: the
program's counter segment.bed_rows (the blocks cli/cmd_segment.py::main
writes) over the seconds of its span segment.bed_write."""

from port_bench.spans import rate


def read(run):
    if run.job != "segment":
        return None
    return rate(run, "segment.bed_rows", "segment.bed_write")
