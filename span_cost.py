#!/usr/bin/env python3
"""What the port's own spans cost, and what they name, in one benchmark
cell (BENCHMARK.json, port_bench/).

    python3 span_cost.py --workload <cell> --seed <n> --seconds <s>
        [--rounds 2] [--device cuda] [--out result.json]

One process sets the cell up and warms it as port_bench/run.py does, then
runs windows of whole jobs back to back, `--rounds` times in turn: "off"
(no profiler, no stage timings: the benchmark's untraced run) and
"spans" (torch.profiler over the window with the stage timings off, so
the program's spans are the only instrumentation and nothing
synchronises). Each window's job walls are printed; each "spans" window
also gives the number of the program's spans a job, the counters
(wgbs_tools_tpu_torch.trace) and the window's idle seconds named by the
innermost span open on the main thread, every name (port_bench's
breakdown keeps the first ten). The last line of standard output is one
JSON object. Nothing is checked against the reference: the benchmark
does that.
"""

import argparse
import json
import os
import os.path as op
import shutil
import statistics
import sys
import tempfile
import time

ROOT = op.dirname(op.abspath(__file__))
# idle seconds put down to no layer: the job as a whole, the window
# outside every span, and the commands' outermost spans
NO_LAYER = ("pat2beta.job", "segment.job", "outside", "pat2beta.run",
            "segment.run")


def log(msg):
    print(f"[span_cost] {msg}", file=sys.stderr, flush=True)


def window(cell, state, seconds, first, after_job):
    """Jobs back to back for `seconds`; returns their walls."""
    from torch.profiler import record_function

    walls = []
    t0 = time.perf_counter()
    with record_function("bench.window"):
        while True:
            t = time.perf_counter()
            with record_function(cell.traffic["job"] + ".job"):
                cell.job.run(state, first + len(walls), None)
            walls.append(time.perf_counter() - t)
            after_job(state)
            if time.perf_counter() - t0 >= seconds:
                return walls


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    cache = op.join(ROOT, "port_bench", ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", op.join(cache, "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", op.join(cache, "triton"))
    import torch

    from port_bench import run, trace_io
    from port_bench.trace_io import Trace, profiled
    from wgbs_tools_tpu_torch import trace

    trace_io.TOP = None  # the breakdown keeps every name, not ten

    cell = run.Cell(args.workload)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: no result")
        return 2
    work = tempfile.mkdtemp(prefix="span_cost_")
    os.environ["WGBS_TPU_REFDIR"] = op.join(work, "refs")

    def drop_outputs(st):
        # each job writes its own output; only the walls are kept
        for path in st.outputs:
            if op.exists(path):
                os.remove(path)
        st.outputs.clear()

    try:
        state = cell.job.setup(cell, args.seed, dev, work)
        cell.job.warmup(state)
        if cuda:
            torch.cuda.synchronize()
        result = {"workload": args.workload, "seed": args.seed,
                  "device": (torch.cuda.get_device_name(dev) if cuda
                             else "cpu"),
                  "windows": []}
        n_jobs = 0
        for r in range(args.rounds):
            for mode in ("off", "spans"):
                entry = {"mode": mode}
                if mode == "off":
                    walls = window(cell, state, args.seconds, n_jobs,
                                   drop_outputs)
                else:
                    trace.reset_counters()
                    with profiled() as prof:
                        walls = window(cell, state, args.seconds, n_jobs,
                                       drop_outputs)
                    path = op.join(work, "trace.json")
                    prof.export_chrome_trace(path)
                    tr = Trace(path)
                    idle = dict(tr.idle_by_span())
                    idle_s = tr.window_s - tr.busy_s
                    no_layer = sum(idle.get(k, 0.0) for k in NO_LAYER)
                    job_spans = [s for s in tr.spans
                                 if s[2] == cell.traffic["job"] + ".job"]
                    entry.update({
                        "spans_per_job": (len(tr.spans) - len(job_spans))
                        / len(walls),
                        "counters": trace.counters(),
                        "window_s": tr.window_s, "busy_s": tr.busy_s,
                        "idle_s": idle_s,
                        "no_layer_idle_share": no_layer / idle_s
                        if idle_s > 0 else None,
                        "idle_by_span": idle})
                    os.remove(path)
                n_jobs += len(walls)
                entry["walls"] = walls
                entry["median_wall"] = statistics.median(walls)
                log(f"round {r} {mode}: job walls "
                    + " ".join(f"{w:.3f}" for w in walls))
                result["windows"].append(entry)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
