"""The program's own spans and counters in a traced run, for the metrics'
readers: spans from the window's main thread (trace_io.Trace.spans),
counters from wgbs_tools_tpu_torch.trace. Each gives None where the
program has none, as a checkout without them has."""


def span_s(run, name):
    """Seconds of the main thread's spans named `name`, or None where the
    trace has none."""
    got = [b - a for a, b, n, _ in run.trace.spans if n == name]
    return sum(got) * 1e-6 if got else None


def share(run, name):
    """Percent of the traced jobs' wall in the spans named `name`, or
    None."""
    s = span_s(run, name)
    if s is None or not run.job_wall_s:
        return None
    return 100.0 * s / run.job_wall_s


def counter(name):
    """The program's counter `name` over the traced window, or None."""
    try:
        from wgbs_tools_tpu_torch import trace
    except ImportError:
        return None
    return trace.counters().get(name)


def rate(run, counter_name, span_name):
    """The counter per second of the spans named `span_name`, or None."""
    n, s = counter(counter_name), span_s(run, span_name)
    if n is None or not s:
        return None
    return n / s
