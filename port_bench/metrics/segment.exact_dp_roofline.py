"""segment.exact_dp_roofline: percent of the exact DP kernel's device time
(the profiler's records of csrc/segment_exact.cu's kernels by name) that
the least time of its work takes: the larger of the bytes over 3.35 TB/s
and the valid band cells x K float64 adds over the FP64 peak
(port_bench/work.py), counted from the loci for every job of the window."""

from port_bench import work


def read(run):
    if run.job != "segment":
        return None
    kernel_s = run.trace.kernel_s(run.cell.job.EXACT_KERNELS)
    if kernel_s <= 0:
        return None
    n_bytes, flops = run.cell.job.work_counts(run.state)
    bound = run.n_jobs * work.bound_s(n_bytes, flops, work.FP64_FLOPS)
    return 100.0 * bound / kernel_s
