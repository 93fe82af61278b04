#!/usr/bin/env python3
"""A/B of the code-word pileup kernels (flat_classic, flat_lc,
tiled_classic) and the v2 fragment-row kernel (tiles_v2) of two source
trees, on one GPU, on the slabs that chip_smoke.py's phase 3 gives them.

    python3 kernel_ab.py OTHER_TREE [--frags N] [--reps R] [--rounds K]

OTHER_TREE is another checkout of this repo (for the parent commit:
`git archive HEAD~1 | tar -x -C build/parent`; build/ is ignored by git).
Each tree's wgbs_tools_tpu_torch/csrc/pileup_v3.cu and pileup_v2.cu are
compiled by nvcc with the port's flags into a library of its own, and both
are called through ctypes on the same staged tensors (staged by this tree;
the layout is the same in both), in turns other, this, this, other (K
rounds). Every output must equal the kernel's plain twin. Times are the
card's (chip_smoke._device_ms: launches queued behind a spinning kernel),
per slab (for the code-word kernels both rc-class launches) and per
rc-class launch. Prints the card's name and power limit, one line per
kernel, slab and run, and last one JSON object with every run's times and
each tree's ptxas registers (the most any template instance uses).
"""

import argparse
import ctypes
import json
import os
import os.path as op
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = op.dirname(op.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SRCS = ("wgbs_tools_tpu_torch/csrc/pileup_v3.cu",
        "wgbs_tools_tpu_torch/csrc/pileup_v2.cu")
# kernel -> (its pats, the staging path of chip_smoke.PHASE3)
KERNELS = {name: chip_smoke.PHASE3[name][:2]
           for name in ("flat_classic", "flat_lc", "tiled_classic",
                        "tiles_v2")}
# C entry -> (device pointers, int64 scalars) before the stream
ENTRIES = {"pileup_flat_classic": (5, 5), "pileup_flat_lc": (6, 5),
           "pileup_tiled_classic": (5, 6), "pileup_tiles_v2": (5, 6)}


def build(tree, out_dir):
    """nvcc the tree's pileup_v3.cu and pileup_v2.cu into out_dir/lib.so;
    returns (the loaded library, {kernel: registers}, whether its tiled
    entry takes max_chunks (the first tiled grid) rather than n_chunks)."""
    from wgbs_tools_tpu_torch import _kernels

    os.makedirs(out_dir, exist_ok=True)
    srcs = [op.join(tree, src) for src in SRCS]
    so = op.join(out_dir, "lib.so")
    proc = subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS
                          + ["-shared", "-o", so] + srcs,
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {srcs}:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs, entry = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in KERNELS if k + "_kernel" in line), None)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = max(regs.get(entry, 0), int(m.group(1)))
    lib = ctypes.CDLL(so)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, (n_ptr, n_int) in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + [i64] * n_int + [vp]
        fn.restype = ctypes.c_int
    with open(srcs[0]) as f:
        max_chunks = "int64_t max_chunks" in f.read()
    return lib, regs, max_chunks


def launcher(tree_lib, name, st, span):
    """A function that launches kernel `name` of a built tree on one
    staged batch into its own output, and the output."""
    import torch

    lib, _, max_chunks = tree_lib
    out = torch.zeros((span, 2), dtype=torch.int32, device=st.device)
    num_tiles = -(-span // st.tile)
    head = [st.c0.data_ptr(), st.c1.data_ptr(), st.meta.data_ptr()]
    if name == "tiles_v2":
        args = head + [st.words.data_ptr(), out.data_ptr(), num_tiles, span,
                       st.tile, st.fc, st.g_max, st.w_cols]
    else:
        planes = [st.rows.data_ptr()] + (
            [st.cnts.data_ptr()] if name == "flat_lc" else [])
        extra = ([st.max_chunks if max_chunks else st.meta.shape[0]]
                 if name == "tiled_classic" else [])
        args = (head + planes + [out.data_ptr(), num_tiles, span, st.tile_sb,
                                 st.rc, st.g_max] + extra)
    fn = getattr(lib, "pileup_" + name)

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pileup_{name}: CUDA error {err}")

    return launch, out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="the other tree (e.g. the parent commit)")
    p.add_argument("--frags", type=int, default=20_000_000)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()

    import torch

    from wgbs_tools_tpu_torch.ops import pileup_v2 as pv2
    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    smi = chip_smoke.phase_card()
    os.makedirs(op.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="kernel_ab_", dir=op.join(REPO, "build"))
    try:
        trees = {"other": build(op.abspath(args.other), op.join(work, "o")),
                 "this": build(REPO, op.join(work, "t"))}
        big, deep = chip_smoke.phase_data(work, args.frags)
        slabs = {"big": chip_smoke._first_slab(big),
                 "deep": chip_smoke._first_slab(deep)}
        dev = torch.device("cuda")
        runs = []
        for name, (pats, path) in KERNELS.items():
            plain = getattr(pv2 if name == "tiles_v2" else pv3,
                            name + "_plain")
            for pat in pats:
                sel, lo, span = slabs[pat]
                sts = chip_smoke._stage(sel, lo, span, dev, path)
                want = sum(plain(st, span) for st in sts)
                calls = {}
                for tree, tl in trees.items():
                    calls[tree] = [launcher(tl, name, st, span) for st in sts]
                    for launch, _ in calls[tree]:
                        launch()
                    torch.cuda.synchronize()
                    got = sum(out for _, out in calls[tree])
                    if not torch.equal(got, want):
                        raise RuntimeError(f"{tree} {name} on {pat}: kernel "
                                           "!= twin")
                order = ["other", "this", "this", "other"] * args.rounds
                for i, tree in enumerate(order):
                    cl = calls[tree]
                    ms = chip_smoke._device_ms(
                        lambda: [launch() for launch, _ in cl], args.reps)
                    per_class = {
                        str(st.rc): chip_smoke._device_ms(launch, args.reps)
                        for st, (launch, _) in zip(sts, cl)
                        if hasattr(st, "rc")}
                    runs.append({"kernel": name, "slab": pat, "tree": tree,
                                 "turn": i, "ms": ms, "class_ms": per_class})
                    chip_smoke.log(f"A/B {name} on {pat} turn {i} {tree}: "
                                   f"{ms:.4f} ms per slab (" + ", ".join(
                                       f"rc {rc} {v:.4f}" for rc, v in
                                       per_class.items()) + ") == twin")
        summary = {}
        for name, (pats, _) in KERNELS.items():
            for pat in pats:
                med = {tree: statistics.median(
                    r["ms"] for r in runs if r["kernel"] == name
                    and r["slab"] == pat and r["tree"] == tree)
                    for tree in trees}
                summary[f"{name} {pat}"] = med
                chip_smoke.log(f"A/B {name} on {pat}: median other "
                               f"{med['other']:.4f} ms, this "
                               f"{med['this']:.4f} ms "
                               f"({med['other'] / med['this']:.2f}x)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps({"card": smi, "reps": args.reps, "median_ms": summary,
                      "registers": {t: tl[1] for t, tl in trees.items()},
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
