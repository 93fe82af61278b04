"""Multi-process pat2beta: N worker processes, one site range each.

Port of the pat2beta job of wgbs_tools_tpu/parallel/multihost.py
(pat2beta_worker :67-157, _worker_main :524-572, free_port :575,
run_pat2beta_multiprocess :583-624). The workers join one
torch.distributed job on the gloo backend. Rank r owns one device,
cuda:{r % device_count} (or the CPU), and the sites [r*S + 1, (r+1)*S + 1)
with S = ceil(nr_sites / world). It streams the pat rows overlapping its
range (formats/pat.py::iter_pat_region), piles them up in a one-shard
ShardedPileupV3 (which clips fragments at the range's edges), saturates on
its device and writes its own byte range of the beta. The pileup needs no
cross-process traffic; the only collectives are one int64 coverage
allgather and two write barriers, all host scalars, which is why gloo and
not NCCL carries them (two ranks on one card cannot use NCCL).

    python -m wgbs_tools_tpu_torch.parallel.multihost --coordinator HOST:PORT \\
        --num_processes N --process_id R --pat x.pat.gz --out x.beta \\
        --nr_sites S [--lbeta] [--device cuda|cpu]

is one worker; run_pat2beta_multiprocess starts N of them on this machine.
"""

import argparse
import datetime
import json
import os
import os.path as op
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from ..formats.pat import iter_pat_region
from ..utils import logger

# the longest a worker waits for the others at init or at a barrier
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def distributed_init(coordinator, num_processes, process_id):
    """Join (or create, for process 0) the gloo process group at
    `coordinator` (host:port)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT)


def worker_device(device, rank):
    """The device rank `rank` runs on: cuda:{rank % device_count} for
    "cuda" (raises when CUDA is absent: a worker never moves to the host
    on its own), the CPU for "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def pat2beta_worker(pat_path, out_path, nr_sites, lbeta=False,
                    device="cuda"):
    """Per-process body of the multi-process pat2beta; every process of
    the group calls it with the same arguments. Process 0 creates the
    output file, every process writes its own byte range, and process 0
    returns the path (the others None)."""
    import torch.distributed as dist

    from ..pipeline.pat2beta import stream_into
    from .sharded import ShardedPileupV3

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = worker_device(device, rank)
    S = -(-nr_sites // world)
    lo = min(rank * S + 1, nr_sites + 1)  # 1-based, inclusive
    hi = min((rank + 1) * S + 1, nr_sites + 1)
    logger.info("multihost pat2beta: p%d streams sites [%d, %d) on %s", rank,
                lo, hi, dev)
    n_seen, cov, beta = 0, 0, None
    t0 = t1 = time.perf_counter()
    if hi > lo:
        acc = ShardedPileupV3([dev], (lo, hi))
        n_seen = stream_into(acc, iter_pat_region(pat_path, (lo, hi)))
        t1 = time.perf_counter()
        beta = acc.finalize(lbeta)
        cov = acc.coverage()
    t2 = time.perf_counter()
    logger.info("multihost pat2beta: p%d streamed %d frags in %.3f s, "
                "saturated and fetched in %.3f s", rank, n_seen, t1 - t0,
                t2 - t1)

    covs = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(covs, torch.tensor([cov], dtype=torch.int64))
    itemsize = 2 if lbeta else 1
    if rank == 0:
        with open(out_path, "wb") as f:
            f.truncate(nr_sites * 2 * itemsize)
    dist.barrier()
    if beta is not None:
        with open(out_path, "r+b") as f:
            f.seek((lo - 1) * 2 * itemsize)
            f.write(np.ascontiguousarray(beta).tobytes())
    dist.barrier()
    logger.info("multihost pat2beta: p%d total coverage %d; %.3f s from "
                "streaming to the written beta", rank,
                int(sum(int(c) for c in covs)), time.perf_counter() - t0)
    return out_path if rank == 0 else None


def _worker_main(argv=None):
    p = argparse.ArgumentParser(prog="wgbs-torch-multihost-worker")
    p.add_argument("--coordinator", help="host:port of process 0")
    p.add_argument("--num_processes", type=int)
    p.add_argument("--process_id", type=int)
    p.add_argument("--pat")
    p.add_argument("--out")
    p.add_argument("--nr_sites", type=int)
    p.add_argument("--lbeta", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    # validate before any init, so usage errors exit with argparse's 2
    if not (args.coordinator and args.num_processes
            and args.process_id is not None):
        p.error("--coordinator/--num_processes/--process_id are required")
    if not (args.pat and args.out and args.nr_sites):
        p.error("--pat/--out/--nr_sites are required")
    if not 0 <= args.process_id < args.num_processes:
        p.error(f"--process_id {args.process_id} outside [0, "
                f"{args.num_processes})")
    import torch.distributed as dist

    from ..ops import pileup_v3

    distributed_init(args.coordinator, args.num_processes, args.process_id)
    try:
        pat2beta_worker(args.pat, args.out, args.nr_sites, lbeta=args.lbeta,
                        device=args.device)
    finally:
        dist.destroy_process_group()
    # one line a caller can parse: this worker's kernel launches
    launches = {name: getattr(pileup_v3, name).launches
                for name in ("flat_vals_fused", "flat_vals", "flat_vals_add",
                             "flat_classic")}
    print(f"[wgbs-torch worker {args.process_id}] launches "
          f"{json.dumps(launches)}", flush=True)
    return 0


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_pat2beta_multiprocess(pat_path, out_path, nr_sites, num_processes=2,
                              lbeta=False, device="cuda", timeout=600):
    """Launcher: run num_processes workers on this machine and block until
    all exit; returns out_path. Each worker's output (its log and its
    launch-count line) is copied to this process's stderr. When a worker
    exits nonzero or `timeout` seconds pass, the others are killed and a
    RuntimeError carries the failing worker's output."""
    resolve_device(device)  # no CUDA: raise here, before any worker starts
    cmd_base = [
        sys.executable, "-m", "wgbs_tools_tpu_torch.parallel.multihost",
        "--coordinator", f"127.0.0.1:{free_port()}",
        "--num_processes", str(num_processes),
        "--pat", pat_path, "--out", out_path, "--nr_sites", str(nr_sites),
        "--device", str(device),
    ]
    if lbeta:
        cmd_base.append("--lbeta")
    env = dict(os.environ)
    env["PYTHONPATH"] = op.dirname(op.dirname(op.dirname(
        op.abspath(__file__)))) + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as td:
        logs = [open(op.join(td, f"w{i}.log"), "w+")
                for i in range(num_processes)]
        procs = [subprocess.Popen(cmd_base + ["--process_id", str(i)],
                                  env=env, stdout=log,
                                  stderr=subprocess.STDOUT)
                 for i, log in enumerate(logs)]
        fail = _wait_all(procs, timeout)
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for i, out in enumerate(outs):
        sys.stderr.write(f"--- worker {i} ---\n{out}")
    sys.stderr.flush()
    if fail is not None:
        i, why = fail
        raise RuntimeError(f"multi-process pat2beta failed: worker {i} "
                           f"{why}:\n{outs[i][-2000:]}")
    return out_path


def _wait_all(procs, timeout):
    """Wait for every process; on the first nonzero exit or at the
    deadline kill the rest. Returns None, or (worker index, reason)."""
    deadline = time.monotonic() + timeout
    fail = None
    while fail is None:
        rcs = [pr.poll() for pr in procs]
        bad = next((i for i, rc in enumerate(rcs) if rc not in (None, 0)),
                   None)
        if bad is not None:
            fail = (bad, f"exited with rc={rcs[bad]}")
        elif None not in rcs:
            break
        elif time.monotonic() > deadline:
            fail = (rcs.index(None), f"timed out after {timeout} s")
        else:
            time.sleep(0.05)
    for pr in procs:
        if pr.poll() is None:
            pr.kill()
        pr.wait()
    return fail

if __name__ == "__main__":
    sys.exit(_worker_main())
