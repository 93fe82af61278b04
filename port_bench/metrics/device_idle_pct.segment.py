"""device_idle_pct.segment: percent of the traced window in which no kernel,
copy or set ran on the card, from the profiler's trace."""


def read(run):
    if run.job != "segment" or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
