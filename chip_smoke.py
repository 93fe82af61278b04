#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wgbs_tools_tpu_torch) on one GPU.

    python3 chip_smoke.py [--frags N]

Phases, each printed as it runs; any failure exits nonzero and prints no
result line:
  1. the card: `nvidia-smi` name and power limit; fails without CUDA.
  2. build: nvcc compiles csrc/*.cu for sm_90a (seconds and ptxas
     register counts printed); the native host library that the staging
     needs must load.
  3. data, then kernels vs twins: a 20M-fragment pat.gz (<= 24 sites each)
     over hg19's 28,217,448 CpG sites and a small pat with counts up to
     3000 are written. Each CUDA kernel is held against its plain PyTorch
     twin on the card on the batch the main path gives it: the first
     streamed slab of its pat (the big pat's for the value-plane kernel,
     the deep pat's for the classic one), staged as PileupAccumulator.add
     stages it at the default geometry; then on the same slab with the
     middle third of its span emptied, so the window has empty tiles.
     Exactly equal (tolerance 0, the counts are integers); kernel and twin
     times (CUDA events) on the unaltered slab.
  4. pat2beta end to end: both pats go through the port's CLI on cuda,
     with the kernels' launch counters set to 0 just before and read just
     after; each .beta / .lbeta must equal the host oracle's bytes (the
     port's "native" backend: wgbs_tools_tpu.native.pileup_native, then
     trim_to_uint). A second, timed run prints seconds per stage.
Then a summary (the card line again, build, end to end), one
{"kernels": [...]} line, and last {"ok": true, "device": ...}.

Scratch data goes to build/ (ignored by git) and is deleted at the end.
"""

import argparse
import json
import os
import os.path as op
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

REPO = op.dirname(op.abspath(__file__))
sys.path.insert(0, REPO)

N_SITES = 28_217_448  # hg19 CpG sites
MAX_LEN = 24
SLAB = 2_000_000      # fragments generated per slab
SOURCE = "wgbs_tools_tpu_torch/csrc/pileup_v3.cu"
REPLACES = {"flat_vals_fused": "wgbs_tools_tpu/ops/pileup_tpu3.py:457",
            "flat_classic": "wgbs_tools_tpu/ops/pileup_tpu3.py:177"}
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# synthetic data: fragments as bench_e2e.py::make_pat draws them, written as
# BGZF pat.gz text here (numpy + zlib) without the JAX package's writer
# ---------------------------------------------------------------------------


def make_slab(rng, n, lo, hi, max_count):
    import numpy as np

    starts = np.sort(rng.integers(lo, max(hi, lo + 1), size=n)).astype(
        np.int32)
    lengths = rng.integers(1, MAX_LEN + 1, size=n).astype(np.int32)
    counts = rng.integers(1, max_count + 1, size=n).astype(np.int32)
    codes = np.where(rng.random((n, MAX_LEN)) < 0.7, 1, 0).astype(np.uint8)
    codes[rng.random((n, MAX_LEN)) < 0.02] = 3
    codes[np.arange(MAX_LEN)[None, :] >= lengths[:, None]] = 3
    return starts, lengths, counts, codes


def _digits(x, width):
    """Decimal digits of x, right-aligned in `width` columns, with the mask
    of the significant ones."""
    import numpy as np

    x = x.astype(np.int64)
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digits = ((x[:, None] // pw) % 10 + ord("0")).astype(np.uint8)
    nd = 1 + (x[:, None] >= pw[None, :-1]).sum(axis=1)
    return digits, np.arange(width)[None, :] >= (width - nd)[:, None]


def pat_text(starts, lengths, counts, codes):
    """pat lines `chr1<TAB>start<TAB>pattern<TAB>count`."""
    import numpy as np

    n = starts.shape[0]

    def const(s):
        a = np.frombuffer(s, np.uint8)
        return np.broadcast_to(a, (n, a.size)), np.ones((n, a.size), bool)

    pattern = np.frombuffer(b"TCH.", np.uint8)[codes]
    cols = [const(b"chr1\t"), _digits(starts, 10), const(b"\t"),
            (pattern, np.arange(MAX_LEN)[None, :] < lengths[:, None]),
            const(b"\t"), _digits(counts, 5), const(b"\n")]
    buf = np.concatenate([c[0] for c in cols], axis=1)
    keep = np.concatenate([c[1] for c in cols], axis=1)
    return buf[keep].tobytes()


def _bgzf_block(data):
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = comp.compress(data) + comp.flush()
    bsize = 18 + len(body) + 8
    if bsize > 65536:
        raise RuntimeError("BGZF block too large")
    head = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", bsize - 1))
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def write_pat_gz(path, n_frags, seed, site_lo, site_hi, max_count, pool):
    """Sorted pat.gz of n_frags fragments over [site_lo, site_hi), written
    slab by slab (disjoint site ranges, so the file is sorted)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_slabs = (n_frags + SLAB - 1) // SLAB
    span = site_hi - MAX_LEN - site_lo
    with open(path, "wb") as f:
        done = 0
        for i in range(n_slabs):
            n = min(SLAB, n_frags - done)
            lo = site_lo + span * i // n_slabs
            hi = site_lo + span * (i + 1) // n_slabs
            text = pat_text(*make_slab(rng, n, lo, hi, max_count))
            blocks = [text[j : j + 65280] for j in range(0, len(text), 65280)]
            for blk in pool.map(_bgzf_block, blocks):
                f.write(blk)
            done += n
        f.write(BGZF_EOF)


def write_genome(refs, n_sites):
    """A one-chromosome reference dir with n_sites CpG sites, set as the
    default genome (the layout of wgbs_tools_tpu/genome/cpg_index.py)."""
    import numpy as np

    gdir = op.join(refs, "hg19sites")
    os.makedirs(gdir)
    loci = (np.arange(n_sites, dtype=np.int64) * 70 + 10).astype(np.int32)
    np.savez(op.join(gdir, "cpg_index.npz"), loci=loci,
             chrom_offsets=np.array([0, n_sites], np.int64),
             chrom_sizes=np.array([int(loci[-1]) + 100], np.int64))
    with open(op.join(gdir, "cpg_index.json"), "w") as f:
        json.dump({"name": "hg19sites", "chroms": ["chr1"],
                   "nr_sites": n_sites}, f)
    os.symlink("hg19sites", op.join(refs, "default"))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s), using "
        f"{torch.cuda.get_device_name(0)}")
    return smi


def _ptxas_registers(build_log):
    """{kernel name: registers per thread} from nvcc's `-Xptxas -v` log."""
    regs, entry = {}, None
    with open(build_log) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = next((k for k in REPLACES if k + "_kernel" in line),
                             None)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                regs[entry] = int(m.group(1))
    return regs


def phase_build():
    from wgbs_tools_tpu_torch import _kernels
    from wgbs_tools_tpu_torch.ops.pileup_v3 import require_native

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.load()
    build_s = time.perf_counter() - t0
    regs = _ptxas_registers(_kernels.BUILD_LOG)
    log(f"phase 2: nvcc built {', '.join(map(op.basename, _kernels.sources()))}"
        f" for sm_90a in {build_s:.3f} s; ptxas registers {regs}")
    require_native()
    log("phase 2: native host library loaded")
    return build_s, regs


def _time_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_data(work, n_frags):
    """The genome and both pats; returns (big, deep) paths."""
    refs = op.join(work, "refs")
    write_genome(refs, N_SITES)
    os.environ["WGBS_TPU_REFDIR"] = refs
    big = op.join(work, "big.pat.gz")
    deep = op.join(work, "deep.pat.gz")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        write_pat_gz(big, n_frags, 20260820, 1, N_SITES, 3, pool)
        write_pat_gz(deep, 200_000, 5, 1, 2_000_000, 3000, pool)
    log(f"phase 3: wrote {n_frags:,} frags ({op.getsize(big) / 1e6:.1f} MB "
        f"pat.gz) and 200,000 frags with counts up to 3000 "
        f"({op.getsize(deep) / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.3f} s")
    return big, deep


def _stage(frags, lo, span, dev):
    """A batch staged as PileupAccumulator.add stages it for the kernels
    (default geometry), as a list of Staged on `dev`."""
    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    staged = pv3.stage_v3(frags.start, frags.length, frags.count,
                          frags.codes, lo, span)
    return pv3.staged_from_numpy(
        staged if isinstance(staged, list) else [staged], dev)


def _kernel_vs_twin(name, kernel, plain, sts, span):
    """Exact comparison of a kernel with its twin; returns max abs err."""
    import torch

    got = sum(kernel(st, span) for st in sts)
    want = sum(plain(st, span) for st in sts)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want).abs().max())
    if not torch.equal(got, want):
        raise RuntimeError(f"{name}: kernel != twin (max abs err {err})")
    return err


def phase_kernels(big, deep):
    """Each kernel vs its twin on the first streamed slab of its pat,
    staged as the main path stages it, and on that slab with a hole."""
    import numpy as np
    import torch

    from wgbs_tools_tpu.formats.pat import iter_pat
    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3
    from wgbs_tools_tpu_torch.ops.pileup import overlap_span
    from wgbs_tools_tpu_torch.pipeline.pat2beta import DEF_CHUNK_BYTES

    dev = torch.device("cuda")
    out = {}
    for name, pat, form, kernel, plain in (
            ("flat_vals_fused", big, "vals", pv3.flat_vals_fused,
             pv3.flat_vals_fused_plain),
            ("flat_classic", deep, "classic", pv3.flat_classic,
             pv3.flat_classic_plain)):
        it = iter_pat(pat, chunk_bytes=DEF_CHUNK_BYTES)
        sel, lo, hi = overlap_span(next(it), (1, N_SITES + 1))
        it.close()
        span = hi - lo
        sts = _stage(sel, lo, span, dev)
        if any(st.form != form for st in sts):
            raise RuntimeError(f"{name}: the slab staged as "
                               f"{[st.form for st in sts]}, not {form!r}")
        err = _kernel_vs_twin(name, kernel, plain, sts, span)
        ms = _time_ms(lambda: [kernel(st, span) for st in sts], 20)
        plain_ms = _time_ms(lambda: [plain(st, span) for st in sts], 5)
        rows = sum(st.rows.shape[0] for st in sts)
        geo = ", ".join(f"rc={st.rc} tile={st.tile} g_max={st.g_max} "
                        f"chunks={st.meta.shape[0]}" for st in sts)
        # the same slab with no fragment starting in the middle third of
        # its span: a window with empty tiles
        start = np.asarray(sel.start)
        hole = (start >= lo + span // 3) & (start < lo + 2 * span // 3)
        holed = _stage(sel.take(np.nonzero(~hole)[0]), lo, span, dev)
        empty = int((sum(st.c1 - st.c0 for st in holed) == 0).sum())
        if not empty:
            raise RuntimeError(f"{name}: the holed slab has no empty tile")
        err = max(err, _kernel_vs_twin(name, kernel, plain, holed, span))
        log(f"phase 3: {name}: kernel == twin (max_abs_err {err}) on the "
            f"first slab of {op.basename(pat)}: {sel.nr_frags:,} frags over "
            f"{span:,} sites, {rows:,} staged rows [{geo}], and on it with "
            f"{int(hole.sum()):,} frags taken out ({empty} empty tiles); "
            f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms per slab "
            f"({len(sts)} launch(es))")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "slab_frags": sel.nr_frags, "slab_sites": span}
    return out


def _same(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_pat2beta(work, big, deep, n_frags):
    """Returns (launches, summary line)."""
    import numpy as np

    from wgbs_tools_tpu_torch.cli.main import main as cli_main
    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3
    from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta

    out_gpu = op.join(work, "gpu")
    os.makedirs(out_gpu)
    pv3.flat_vals_fused.launches = 0
    pv3.flat_classic.launches = 0
    t0 = time.perf_counter()
    if cli_main(["pat2beta", big, deep, "-o", out_gpu, "--device", "cuda"]):
        raise RuntimeError("pat2beta CLI failed")
    wall = time.perf_counter() - t0
    if cli_main(["pat2beta", deep, "-l", "-o", out_gpu, "--device", "cuda"]):
        raise RuntimeError("pat2beta -l CLI failed")
    launches = {"flat_vals_fused": pv3.flat_vals_fused.launches,
                "flat_classic": pv3.flat_classic.launches}
    cli = (f"CLI pat2beta on cuda: {wall:.3f} s for both pats "
           f"({(n_frags + 200_000) / wall / 1e6:.3f} M frags/s); kernel "
           f"launches {launches}")
    log("phase 4: " + cli)
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")

    t0 = time.perf_counter()
    for pat, lbeta in ((big, False), (deep, False), (deep, True)):
        suff = ".lbeta" if lbeta else ".beta"
        name = op.basename(pat)[: -len(".pat.gz")]
        oracle = pat2beta(pat, lbeta=lbeta, backend="native", device="cpu",
                          out_path=op.join(work, name + ".oracle" + suff))
        got = op.join(out_gpu, name + suff)
        size = N_SITES * 2 * (2 if lbeta else 1)
        if op.getsize(got) != size or not _same(got, oracle):
            raise RuntimeError(f"{got} differs from the host oracle")
        beta = np.fromfile(got, np.uint16 if lbeta else np.uint8)
        cov = beta[1::2].astype(np.float64)
        log(f"phase 4: {name}{suff} == host oracle, {size:,} bytes, "
            f"mean cov {cov.mean():.4f}, covered sites "
            f"{int((cov > 0).sum()):,}")
    log(f"phase 4: host oracle runs took {time.perf_counter() - t0:.3f} s")

    timings = {}
    t0 = time.perf_counter()
    timed_out = pat2beta(big, device="cuda", timings=timings,
                         out_path=op.join(work, "timed.beta"))
    total = time.perf_counter() - t0
    if not _same(timed_out, op.join(out_gpu, "big.beta")):
        raise RuntimeError("the timed run wrote other bytes")
    stages = (f"stage seconds (timed run of the big pat, {n_frags:,} frags; "
              "decode = wait for the lookahead's slab, device synchronized "
              "after each device stage): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in timings.items())
              + f"; total {total:.3f}")
    log("phase 4: " + stages)
    return launches, cli + "; " + stages


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frags", type=int, default=20_000_000,
                   help="fragments in the big pat (default 20,000,000)")
    args = p.parse_args()

    import torch

    smi = phase_card()
    build_s, regs = phase_build()
    os.makedirs(op.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=op.join(REPO, "build"))
    try:
        big, deep = phase_data(work, args.frags)
        kernels = phase_kernels(big, deep)
        launches, e2e = phase_pat2beta(work, big, deep, args.frags)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # a summary at the end, which a log that keeps only its tail still shows
    print(smi, flush=True)
    log("end to end: " + e2e)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         **kernels[name], "build_s": build_s,
         "registers": regs.get(name)} for name in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # report which phase failed, exit nonzero
        import traceback

        traceback.print_exc()
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
