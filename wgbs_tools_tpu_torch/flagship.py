"""The flagship step on the port: a one-device forward and a multi-device
dry run, the counterparts of __graft_entry__.py's `entry` and
`dryrun_multichip`.

The flagship model of wgbs_tools is the fused methylome-analysis step:
pat-fragment pileup over the CpG axis -> per-site counts -> multi-sample
segmentation cost -> the serial change-point DP. `entry()` gives it as one
forward function on one device with example arguments at JAX's shapes;
`dryrun_multichip(n)` runs the sharded step (parallel/sharded.py::
AnalysisStep) over a (samples, sites) mesh of n devices, then the parallel
layer's other paths, with JAX's checks in JAX's order. Devices repeat
round-robin (parallel/mesh.py), so n stand-in devices run on one card or
on the CPU. Both run on the card unless the caller asks for "cpu".

    python -m wgbs_tools_tpu_torch.flagship [N] [--device cuda|cpu]
"""

import argparse
import os.path as op
import sys
import tempfile

import numpy as np
import torch

from .device import resolve_device
from .ops.dp_scan import dp_scan
from .parallel.sharded import _local_pileup, _segment_cost_local

# entry()'s shapes (JAX's)
N_SITES, N_FRAGS, N_SAMPLES, W, MAX_BP, PC = 4096, 2048, 2, 64, 2000, 15.0


def _synth_inputs(n_sites, n_frags, n_samples, max_len=16, seed=0):
    rng = np.random.default_rng(seed)
    start = np.sort(rng.integers(1, n_sites, size=n_frags)).astype(np.int32)
    length = rng.integers(1, max_len + 1, size=n_frags).astype(np.int32)
    count = rng.integers(1, 4, size=n_frags).astype(np.int32)
    codes = rng.integers(0, 2, size=(n_frags, max_len)).astype(np.uint8)
    cols = np.arange(max_len)[None, :]
    codes[cols >= length[:, None]] = 3
    cov = rng.integers(0, 20, size=(n_samples, n_sites)).astype(np.int32)
    meth = (cov * rng.random((n_samples, n_sites))).astype(np.int32)
    sample_counts = np.stack([meth, cov], axis=2)
    loci = (np.cumsum(rng.integers(2, 60, size=n_sites))).astype(np.int32)
    return start, length, count, codes, sample_counts, loci


def entry(device="cuda"):
    """One-device forward step + example args: (forward, args).

    forward(start, length, count, codes, sample_counts, loci) -> (merged
    (n, 2) int32, tb (n,) int32, total coverage): the fragments' pileup
    (_local_pileup: tiles_v1 on the card), merged with every sample's
    counts, the cost summed over samples (_segment_cost_local) and the DP
    (dp_scan). The fragment arrays are host numpy arrays (the pileup stages
    them on the host); sample_counts and loci are tensors on the device.
    The total coverage is exact in int64 (JAX's int32 sum wraps past
    2^31)."""
    dev = resolve_device(device)

    def forward(start, length, count, codes, sample_counts, loci):
        counts = _local_pileup(start - 1, length, count, codes, N_SITES, dev)
        merged = sample_counts.sum(dim=0, dtype=torch.int32) + counts
        cost = torch.zeros((1, N_SITES, W), dtype=torch.float32, device=dev)
        for d in range(sample_counts.shape[0]):
            _segment_cost_local(sample_counts[d] + counts, loci, W, MAX_BP,
                                PC, out=cost[0])
        tb = dp_scan(cost, W)[0]
        return merged, tb, counts[:, 1].sum(dtype=torch.int64)

    start, length, count, codes, sample_counts, loci = _synth_inputs(
        N_SITES, N_FRAGS, N_SAMPLES)
    args = (start, length, count, codes,
            torch.from_numpy(sample_counts).to(dev),
            torch.from_numpy(loci).to(dev))
    return forward, args


def _write_pat(frags, path):
    """Sorted fragments as a BGZF pat.gz (the port's host compressor)."""
    from .native import bgzf_compress_native

    letters = np.frombuffer(b"TCH.", np.uint8)
    lines = [b"chr1\t%d\t%s\t%d\n" % (s, letters[c[:n]].tobytes(), k)
             for s, n, k, c in zip(frags.start.tolist(),
                                   frags.length.tolist(),
                                   frags.count.tolist(), frags.codes)]
    with open(path, "wb") as f:
        f.write(bgzf_compress_native(b"".join(lines)))


def dryrun_multichip(n_devices, device="cuda"):
    """Run ONE sharded analysis step on an n_devices mesh, then the
    parallel layer's other paths, each checked as JAX's dry run checks it:
    segment_windows_sharded over n_devices + 1 windows, sharded pat2beta
    against one device, fast segment_ranges, reduce_data_to_blocks over
    n_devices site shards (blocks of 64 sites: the coverage column sums to
    the beta's, and the shards' sums equal one device's), ShardedPileupV3
    against one device's pileup, and 2-process pat2beta against one
    process. Prints one summary line."""
    from .formats.beta import load_beta, save_beta
    from .formats.pat import PatFrags
    from .models.segment import SegmentConfig, segment_ranges
    from .ops.pileup import pileup_frags
    from .ops.reduceat import reduce_data_to_blocks
    from .parallel.mesh import make_mesh, shard_devices
    from .parallel.multihost import run_pat2beta_multiprocess
    from .parallel.sharded import (AnalysisStep, ShardedPileupV3,
                                   bucket_fragments, decode_sum64,
                                   segment_windows_sharded)
    from .pipeline.pat2beta import pat2beta

    dev = resolve_device(device)
    samples_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, samples_axis=samples_axis, device=dev)
    sites_shards = mesh.shape["sites"]

    n_sites = 512 * sites_shards
    n_samples = 2 * samples_axis
    max_len = 16
    halo = 32
    w = 32

    start, length, count, codes, sample_counts, loci = _synth_inputs(
        n_sites, 1024, n_samples, max_len=max_len, seed=1)
    rs, ln, cn, cd = bucket_fragments(start, length, count, codes, n_sites,
                                      sites_shards)
    step = AnalysisStep(mesh, n_sites, halo=halo, W=w, max_bp=2000, pc=15.0)
    counts, tb, cov_lo, cov_f = step(rs, ln, cn, cd, sample_counts,
                                     loci[:, None])
    total_cov = decode_sum64(cov_lo, cov_f)
    assert counts.shape == (n_sites, 2)
    assert tb.shape == (n_sites,)
    assert int(total_cov) >= 0

    # window-sharded fast segmentation: the window batch axis split over
    # every device of the mesh
    rng = np.random.default_rng(2)
    nw, K, n = n_devices + 1, 2, 384  # +1 exercises the host padding path
    cov = rng.integers(1, 20, size=(nw, K, n))
    meth = rng.binomial(cov, rng.random((nw, K, 1)))
    datas = np.stack([meth, cov], axis=3)
    locis = np.cumsum(rng.integers(2, 60, size=(nw, n)), axis=1) + 50
    borders = segment_windows_sharded(mesh, datas, locis, max_cpg=64,
                                      max_bp=2000, pseudo_count=15.0)
    assert len(borders) == nw and all(b[0] == 0 and b[-1] == n
                                      for b in borders)

    # the CLI's code paths on n site shards: a pat streamed into the
    # sharded pileup against one device, then fast segment_ranges
    shards = shard_devices(dev, n_shards=n_devices)
    n_cli = 1 << 17
    rngc = np.random.default_rng(3)
    fs = np.sort(rngc.integers(1, n_cli - 20, size=5000)).astype(np.int32)
    fl = rngc.integers(1, 13, size=5000).astype(np.int32)
    fc = rngc.integers(1, 3, size=5000).astype(np.int32)
    fcd = rngc.integers(0, 2, size=(5000, 12)).astype(np.uint8)
    fcd[np.arange(12)[None, :] >= fl[:, None]] = 3
    frags = PatFrags(fs, fl, fc, fcd, np.zeros(5000, np.int16), ["chr1"],
                     None)

    class _G:
        nr_sites = n_cli

        class index:
            loci = np.cumsum(np.full(n_cli, 20, np.int64))

    with tempfile.TemporaryDirectory() as td:
        pat = op.join(td, "d.pat.gz")
        _write_pat(frags, pat)
        beta1 = pat2beta(pat, genome=_G, device=dev, devices=shards,
                         out_path=op.join(td, "sh.beta"),
                         chunk_bytes=1 << 15)
        beta0 = pat2beta(pat, genome=_G, device=dev, sharded=False,
                         out_path=op.join(td, "si.beta"),
                         chunk_bytes=1 << 15)
        b1 = open(beta1, "rb").read()
        assert b1 == open(beta0, "rb").read(), "sharded beta != single"

        save_beta(op.join(td, "s0.beta"), np.stack(
            [np.frombuffer(b1, np.uint8)[0::2],
             np.frombuffer(b1, np.uint8)[1::2]], axis=1))
        cfg = SegmentConfig(max_cpg=64, max_bp=2000, chunk_size=n_cli // 4,
                            mode="fast", device=dev)
        st, en = segment_ranges([op.join(td, "s0.beta")],
                                [(1, n_cli + 1)], _G.index, cfg)
        assert len(st) > 0 and (en > st).all()

        # the block sums over the shards (JAX's sharded segment_sum)
        data = load_beta(op.join(td, "s0.beta"))
        bs = np.arange(1, n_cli - 64, 64, dtype=np.int64)
        red = reduce_data_to_blocks(data, bs, bs + 64, device=shards)
        assert int(red[:, 1].sum()) == int(
            data[: int(bs[-1] + 63), 1].sum())
        assert np.array_equal(red, reduce_data_to_blocks(
            data, bs, bs + 64, device=dev)), "sharded block sums != single"

    # the v3 kernels per site shard (pat2beta's sharded path) against one
    # device's v3 pileup, bit for bit
    accv3 = ShardedPileupV3(shards, (1, n_cli + 1))
    accv3.add(frags)
    expectc = pileup_frags(frags, (1, n_cli + 1), device=dev).cpu().numpy()
    assert (accv3.result() == expectc).all(), "v3 sharded pileup != single"

    # multi-PROCESS pat2beta: 2 OS processes in one torch.distributed job,
    # each its own site range; the beta must equal one process's bytes
    with tempfile.TemporaryDirectory() as td:
        pat = op.join(td, "mh.pat.gz")
        _write_pat(frags, pat)
        single = pat2beta(pat, genome=_G, device=dev, sharded=False,
                          out_path=op.join(td, "s.beta"))
        multi = run_pat2beta_multiprocess(
            pat, op.join(td, "m.beta"), n_cli, num_processes=2,
            device=str(dev), timeout=300)
        assert open(multi, "rb").read() == open(single, "rb").read(), \
            "multi-process beta != single-process beta"
        mh_frags = int(frags.count.sum())

    print(
        f"[dryrun_multichip] ok: mesh={dict(mesh.shape)} "
        f"counts={tuple(counts.shape)} total_cov={int(total_cov)} "
        f"seg_windows={nw} cli_blocks={len(st)} cli_beta_bytes={len(b1)} "
        f"reduce_blocks={red.shape[0]} reduce_cov={int(red[:, 1].sum())} "
        f"multiproc_beta_ok frags={mh_frags}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="wgbs_tools_tpu_torch.flagship")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("[entry] ok:", [tuple(getattr(o, "shape", ())) for o in out])
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
