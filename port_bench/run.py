#!/usr/bin/env python3
"""The benchmark of wgbs_tools_tpu_torch (the PyTorch and CUDA port) on
one NVIDIA H100.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything a cell needs is found by name. The cell's entry in
BENCHMARK.json names a configuration, whose file (configs/<name>.json)
holds its sizes and has its plain reference beside it
(configs/<name>.py), and a traffic mix (workloads/<traffic>.json), whose
"job" names the driver of its jobs (jobs/<job>.py). Each per-layer metric
is read by metrics/<metric>.py.

A run makes its inputs from the seed under $TMPDIR, warms up, then runs
whole jobs back to back on one process's warm state, and starts none
after --seconds. A rate is the work of all its jobs over the time from
the first job's start to the last one's end. Once the window has closed
it frees the program's state and holds every job's output to the
configuration's reference. The last line of standard output is one JSON
object; the numbers compared, beside their limits, are the last lines of
standard error and the last key of that object.

--trace 1 runs the same jobs under torch.profiler, with the program's
stage timings on (which synchronise the device at each stage's end), and
reports the per-layer metrics, the device's busy time and a breakdown.
--trace 0 reports the end-to-end metrics and reads no span.

The run exits non-zero without a result when CUDA or the cell's number of
cards is missing, or when jax, jaxlib, flax or wgbs_tools_tpu is among
the loaded modules once the window has closed.
"""

import argparse
import gc
import importlib.util
import json
import os
import os.path as op
import shutil
import subprocess
import sys
import tempfile
import time

HERE = op.dirname(op.abspath(__file__))
ROOT = op.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "wgbs_tools_tpu")


def _process_start():
    """Wall-clock seconds since the epoch at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = _process_start()


def log(msg):
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_limits():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "a card whose power limit nvidia-smi did not read"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, job
    driver and metrics, all found by name under port_bench/."""

    def __init__(self, name, bench=None):
        if bench is None:
            with open(op.join(ROOT, "BENCHMARK.json")) as f:
                bench = json.load(f)
        self.bench = bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        cfg_path = op.join(ROOT, conf["file"])
        with open(cfg_path) as f:
            self.config = json.load(f)
        self.reference = load_file(cfg_path[:-len(".json")] + ".py",
                                   "port_bench_ref_" + conf["name"])
        with open(op.join(HERE, "workloads",
                          self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        job = self.traffic["job"]
        self.job = load_file(op.join(HERE, "jobs", job + ".py"),
                             "port_bench_job_" + job)

    def metrics(self, kind):
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


class RunInfo:
    """What a metric's reader is given: the traced run's jobs, the
    program's stage seconds, its work counts and the trace."""

    def __init__(self, cell, state, walls, timings, trace):
        self.cell = cell
        self.job = cell.traffic["job"]
        self.state = state
        self.job_wall_s = sum(walls)
        self.n_jobs = len(walls)
        self.timings = timings
        self.trace = trace

    def share(self, *keys):
        """Percent of the jobs' wall spent in the stage timings `keys`, or
        None where the run has none of them."""
        if not any(k in self.timings for k in keys) or not self.job_wall_s:
            return None
        return 100.0 * sum(self.timings.get(k, 0.0) for k in keys) \
            / self.job_wall_s


def _wrap_spans(spans):
    """Put a record_function range around each (module, attribute, name)
    entry of the program; returns the undo list."""
    import importlib

    from torch.profiler import record_function

    undo = []
    for mod, attr, name in spans:
        owner = importlib.import_module(mod.rsplit(":", 1)[0])
        if ":" in mod:
            owner = getattr(owner, mod.rsplit(":", 1)[1])
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, fn))
    return undo


def run_cell(cell, seed, seconds, trace=False, device="cuda", control=False):
    """One run of `cell`; returns the result object. `control` puts the
    reference in the precision below the cell's in the program's place
    for the check (the tests' control)."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    work = tempfile.mkdtemp(prefix="port_bench_")
    os.environ["WGBS_TPU_REFDIR"] = op.join(work, "refs")
    try:
        state = cell.job.setup(cell, seed, dev, work)
        cell.job.warmup(state)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.time() - T_PROCESS
        log(f"set-up {setup_s:.3f} s")

        timings = {} if trace else None
        undo = _wrap_spans(cell.job.SPANS) if trace else []
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        walls, units = [], {}
        prof_path = op.join(work, "trace.json")
        failed_jobs = 0

        def window():
            from torch.profiler import record_function

            t0 = time.perf_counter()
            with record_function("bench.window"):
                while True:
                    t = time.perf_counter()
                    with record_function(cell.traffic["job"] + ".job"):
                        got = cell.job.run(state, len(walls), timings)
                    walls.append(time.perf_counter() - t)
                    for k, v in got.items():
                        units[k] = units.get(k, 0) + v
                    if time.perf_counter() - t0 >= seconds:
                        break
            return t0, time.perf_counter()

        try:
            if trace:
                from port_bench.trace_io import profiled

                with profiled() as prof:
                    t0, t1 = window()
                t = time.perf_counter()
                prof.export_chrome_trace(prof_path)
                log(f"trace written in {time.perf_counter() - t:.3f} s")
            else:
                t0, t1 = window()
        except Exception as exc:  # a job that raised: no rate, not correct
            log(f"job {len(walls)} raised: {exc!r}")
            failed_jobs += 1
            t0 = t1 = None
        for owner, attr, fn in undo:
            setattr(owner, attr, fn)
        span = (t1 - t0) if t0 is not None else None
        if walls:
            log("job walls " + " ".join(f"{w:.3f}" for w in walls))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

        metrics = {}
        if trace and span:
            from port_bench.trace_io import Trace

            t = time.perf_counter()
            tr = Trace(prof_path)
            log(f"trace read in {time.perf_counter() - t:.3f} s")
            log(f"rooflines: kernel time from the profiler's kernel records "
                f"on {card_limits()}")
            info = RunInfo(cell, state, walls, timings, tr)
            for m in cell.metrics("per_layer"):
                reader = load_file(op.join(HERE, "metrics", m["name"] + ".py"),
                                   "port_bench_metric_" + m["name"])
                value = reader.read(info)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif span:
            for m in cell.metrics("end_to_end"):
                if m["name"] == "setup_s":
                    metrics[m["name"]] = {"value": setup_s, "unit": m["unit"]}
                elif m["name"] in units:
                    metrics[m["name"]] = {"value": units[m["name"]] / span,
                                          "unit": m["unit"]}

        # every job frees its own state; what is left goes before the check
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks, bad_jobs = cell.job.check(state, len(walls), control=control)
        log(f"check {time.perf_counter() - t:.3f} s")
        failed_jobs += bad_jobs
        correct = failed_jobs == 0 and all(
            c["value"] <= c["limit"] for c in checks.values())
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(dev) if cuda
                       else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": bool(correct),
                  "attempted": len(walls) + (span is None),
                  "failed": failed_jobs, "metrics": metrics,
                  "device": device_info}
        if trace and span:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's and torch's build caches at fixed paths in the checkout
    cache = op.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", op.join(cache, "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", op.join(cache, "triton"))
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: no result")
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        log(f"{torch.cuda.device_count()} cards, the cell asks for "
            f"{cell.entry['chips']}: no result")
        return 2
    result = run_cell(cell, args.seed, args.seconds, trace=bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    checks = result.get("checks", {})
    for name, c in checks.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
