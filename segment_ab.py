#!/usr/bin/env python3
"""A/B of the port's `segment` CLI of two source trees, end to end, on one
GPU, at chip_smoke.py phase 8's size.

    python3 segment_ab.py OTHER_TREE [--mode fast|exact] [--rounds K]

OTHER_TREE is another checkout of this repo (for the parent commit:
`git archive HEAD~1 | tar -x -C build/parent`; build/ is ignored by git).
Phase 8's data is written once (chip_smoke.write_seg_data: 3 betas over
28,217,448 sites from its seed, genome hg19seg); then `segment --mode
MODE --device cuda` with phase 8's flags runs in a fresh process per
run, with each tree on PYTHONPATH, in turns other, this, this, other (K
rounds). A run builds its tree's kernels before its clock starts, then
times cmd_segment.main as phase 8 does (wall and stage seconds, each
device stage synchronized) and reads the kernels' launch counters. Every
run's bed must equal the first run's bytes (fast mode's borders do not
depend on which tree's kernel ran: both are held to the same twin).
Prints the card's name and power limit, one line per run, the medians,
and last one JSON object with every run.
"""

import argparse
import filecmp
import json
import os
import os.path as op
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = op.dirname(op.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# one run in a fresh process: argv = [bed, cmd_segment's arguments...]
RUN = """
import json, sys, time
from wgbs_tools_tpu_torch import _kernels
from wgbs_tools_tpu_torch.cli import cmd_segment
from wgbs_tools_tpu_torch.ops import maxplus, segment_exact
_kernels.load()
timings = {}
t0 = time.perf_counter()
if cmd_segment.main(sys.argv[2:] + ["-o", sys.argv[1]], timings=timings):
    sys.exit("segment failed")
wall = time.perf_counter() - t0
print(json.dumps({"wall": wall, "timings": timings, "launches": {
    "maxplus_closure": maxplus.maxplus_closure.launches,
    "segment_exact_dp": segment_exact.segment_exact_dp.launches}}))
"""


def run(tree, bed, args, refs):
    env = dict(os.environ, PYTHONPATH=tree, WGBS_TPU_REFDIR=refs)
    proc = subprocess.run([sys.executable, "-c", RUN, bed] + args, env=env,
                          cwd=tree, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError(f"segment in {tree} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="the other tree (e.g. the parent commit)")
    p.add_argument("--mode", choices=["fast", "exact"], default="fast")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()

    smi = chip_smoke.phase_card()
    trees = {"other": op.abspath(args.other), "this": REPO}
    os.makedirs(op.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="segment_ab_", dir=op.join(REPO, "build"))
    runs = []
    try:
        refs = op.join(work, "refs")
        betas, _ = chip_smoke.write_seg_data(work, refs)
        a = chip_smoke.SEG_ARGS
        cli = (["--betas"] + betas + ["--genome", chip_smoke.SEG_GENOME,
               "--max_cpg", str(a["max_cpg"]), "--max_bp", str(a["max_bp"]),
               "-p", str(a["pcount"]), "--mode", args.mode, "--device",
               "cuda"])
        first = None
        order = (list(trees) + list(trees)[::-1]) * args.rounds
        for i, tree in enumerate(order):
            bed = op.join(work, f"run{i}.bed")
            r = dict(run(trees[tree], bed, cli, refs), tree=tree, turn=i)
            first = first or bed
            if not filecmp.cmp(bed, first, shallow=False):
                raise RuntimeError(f"run {i} ({tree}): the bed differs from "
                                   "run 0's")
            runs.append(r)
            stages = ", ".join(f"{k} {v:.3f}" for k, v in
                               r["timings"].items())
            chip_smoke.log(f"A/B segment --mode {args.mode} turn {i} {tree}: "
                           f"{r['wall']:.3f} s ({stages}); launches "
                           f"{r['launches']}; bed == run 0's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    med = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        med[tree] = {"wall": statistics.median(r["wall"] for r in mine),
                     **{k: statistics.median(r["timings"][k] for r in mine)
                        for k in mine[0]["timings"]}}
        chip_smoke.log(f"A/B segment --mode {args.mode}: median {tree} "
                       + ", ".join(f"{k} {v:.3f}" for k, v in
                                   med[tree].items()))
    print(smi, flush=True)
    print(json.dumps({"card": smi, "mode": args.mode, "median_s": med,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
