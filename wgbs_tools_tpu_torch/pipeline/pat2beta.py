"""pat -> beta conversion on torch devices.

Port of wgbs_tools_tpu/pipeline/pat2beta.py. The pat file streams in
slabs of 32 MB of file bytes (formats/pat.py::iter_pat, the native
multithreaded BGZF inflater and parser), each slab piles up into a
device-resident total, and the total is saturated on the device and
written as .beta / .lbeta. On one device the total is
ops/pileup.py::PileupAccumulator's; over site shards on several devices
(or several shards on one) it is parallel/sharded.py::ShardedPileupV3's.
Counts are integer adds, so every backend, device and sharding writes the
same bytes.
"""

import os.path as op
from concurrent.futures import ThreadPoolExecutor

import torch

from ..device import resolve_device, timed
from ..formats.pat import DEF_CHUNK_BYTES, iter_pat
from ..genome.refdir import Genome
from ..ops.pileup import PileupAccumulator
from ..parallel.mesh import shard_devices
from ..parallel.sharded import ShardedPileupV3
from ..utils import logger, splitextgz


def _accumulator(window, device, backend, timings, sharded, devices,
                 forms=None):
    """The single-device accumulator or the sharded one. sharded=None
    means sharded when `device` is CUDA and more than one card is visible
    (as the JAX package decides by its visible devices); an explicit
    `devices` list forces the sharded path, one shard per list entry.
    `forms` are the v3 form keywords (ops/pileup.py's table) for the
    single-device accumulator; the sharded path stages value planes only,
    so it takes none of them."""
    forms = forms or {}
    if devices is None:
        dev = resolve_device(device)
        if sharded is None:
            sharded = dev.type == "cuda" and torch.cuda.device_count() > 1
        if not sharded:
            return PileupAccumulator(window, dev, backend, timings=timings,
                                     **forms)
        devices = shard_devices(dev)
    elif sharded is False:
        raise ValueError("sharded=False contradicts an explicit devices list")
    if backend != "cuda":
        raise ValueError(f"the sharded path runs the kernels (backend "
                         f"'cuda'), not {backend!r}")
    if forms:
        raise ValueError(f"the sharded path stages value planes only; it "
                         f"takes no form keywords ({', '.join(forms)})")
    return ShardedPileupV3([resolve_device(d) for d in devices], window,
                           timings=timings)


def stream_into(acc, batches, timings=None):
    """Fold an iterator of PatFrags batches into the accumulator `acc`;
    returns the number of fragments. One-slab lookahead: the next slab
    decompresses and parses (native code, GIL released) in a thread while
    the current one stages and piles up. With `timings`, "decode" is the
    time spent waiting for the next slab."""
    nf = 0
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(next, batches, None)
        while True:
            with timed(timings, "decode", None):
                chunk = fut.result()
            if chunk is None:
                break
            fut = ex.submit(next, batches, None)
            acc.add(chunk)
            nf += chunk.nr_frags
    return nf


def _accumulate_pat(pat_path, nr_sites, device, backend="cuda",
                    chunk_bytes=DEF_CHUNK_BYTES, timings=None, sharded=None,
                    devices=None, **forms):
    """Stream a pat file into a pileup accumulator. Returns
    (accumulator, nr_frags)."""
    acc = _accumulator((1, nr_sites + 1), device, backend, timings, sharded,
                       devices, forms)
    nf = stream_into(acc, iter_pat(pat_path, chunk_bytes=chunk_bytes),
                     timings)
    return acc, nf


def pat2beta(pat_path, out_dir=".", genome=None, lbeta=False, backend="cuda",
             out_path=None, chunk_bytes=DEF_CHUNK_BYTES, device="cuda",
             timings=None, sharded=None, devices=None, **forms):
    """Convert a pat[.gz] file to a beta/lbeta file on `device` ('cuda'
    raises without CUDA; 'cpu' runs the kernels' plain twins). Returns the
    output path. With more than one visible card (sharded=None), with
    sharded=True, or with an explicit `devices` list (one site shard per
    entry, see parallel/mesh.py::shard_devices) the table is sharded over
    the site axis. On one device, `backend` ("cuda", "cuda_v2", "cuda_v1",
    or on the CPU "torch" or "native") and the v3 form keywords `forms`
    (fused, vals, lane_counts, grid; ops/pileup.py's table maps them to
    the JAX package's switches) pick the pileup; every choice writes the
    same bytes. With `timings` (a dict), the seconds of each stage (decode
    wait, stage, h2d, kernel, saturate_fetch, write) accumulate there; the
    device is synchronized at the end of each device stage, and the decode
    lookahead runs as it does untimed."""
    g = genome if genome is not None else Genome(None)
    nr_sites = g.get_nr_sites() if hasattr(g, "get_nr_sites") else g.nr_sites

    acc, nf = _accumulate_pat(pat_path, nr_sites, device, backend=backend,
                              chunk_bytes=chunk_bytes, timings=timings,
                              sharded=sharded, devices=devices, **forms)
    beta = acc.finalize(lbeta)
    suff = ".lbeta" if lbeta else ".beta"
    if out_path is None:
        out_path = op.join(out_dir, splitextgz(op.basename(pat_path))[0] + suff)
    with timed(timings, "write", None):
        beta.tofile(out_path)
    logger.info("pat2beta: %s -> %s (%d frags, %d sites, %s)", pat_path,
                out_path, nf, nr_sites,
                getattr(acc, "devices", None) or acc.device)
    return out_path


def pat2beta_counts(pat_path, nr_sites, backend="cuda", device="cuda",
                    sharded=None, devices=None, **forms):
    """Raw (nr_sites, 2) int64 counts (before saturation) of a pat file;
    `backend` and `forms` as in pat2beta."""
    acc, _ = _accumulate_pat(pat_path, nr_sites, device, backend=backend,
                             sharded=sharded, devices=devices, **forms)
    return acc.result()
