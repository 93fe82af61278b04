"""pat2beta.pileup_roofline: percent of the pileup kernels' device time
(the profiler's kernel records by name) that the least time of their
work takes: the larger of the bytes over 3.35 TB/s and the integer adds
over the 32-bit integer peak (port_bench/work.py), the work counted from
the pat lines (work.pileup_work) for every job of the window."""

from port_bench import work


def read(run):
    if run.job != "pat2beta":
        return None
    kernel_s = run.trace.kernel_s(run.cell.job.PILEUP_KERNELS)
    if kernel_s <= 0:
        return None
    n_bytes, ops = run.cell.job.work_counts(run.state)
    bound = run.n_jobs * work.bound_s(n_bytes, ops, work.INT32_OPS)
    return 100.0 * bound / kernel_s
