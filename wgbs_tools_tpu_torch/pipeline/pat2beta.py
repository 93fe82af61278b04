"""pat -> beta conversion on one torch device.

Port of wgbs_tools_tpu/pipeline/pat2beta.py (its single-device branch).
The pat file streams in slabs of 32 MB of file bytes
(formats/pat.py::iter_pat, the native multithreaded BGZF inflater and
parser), each slab piles up into the device-resident total (ops/pileup.py::PileupAccumulator), and the total is
saturated on the device and written as .beta / .lbeta. Counts are integer
adds, so every backend and device writes the same bytes.
"""

import os.path as op
from concurrent.futures import ThreadPoolExecutor

from wgbs_tools_tpu.formats.pat import iter_pat
from wgbs_tools_tpu.genome.refdir import Genome
from wgbs_tools_tpu.utils import splitextgz
from wgbs_tools_tpu.utils.log import logger

from ..device import timed
from ..ops.pileup import PileupAccumulator

# one streamed slab: iter_pat reads this many bytes of the file at a time,
# so a BGZF pat.gz slab is 32 MB compressed (~5M fragments of <= 24 sites)
# and a plain-text pat slab 32 MB of text; host peak memory stays O(slab)
DEF_CHUNK_BYTES = 32 << 20


def _accumulate_pat(pat_path, nr_sites, device, backend="cuda",
                    chunk_bytes=DEF_CHUNK_BYTES, timings=None):
    """Stream a pat file into a pileup accumulator. Returns
    (accumulator, nr_frags). With `timings`, "decode" is the time spent
    waiting for the lookahead's next slab."""
    acc = PileupAccumulator((1, nr_sites + 1), device, backend,
                            timings=timings)
    nf = 0
    it = iter_pat(pat_path, chunk_bytes=chunk_bytes)
    # one-slab lookahead: the next slab decompresses and parses (native
    # code, GIL released) while the current one stages and piles up
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(next, it, None)
        while True:
            with timed(timings, "decode", None):
                chunk = fut.result()
            if chunk is None:
                break
            fut = ex.submit(next, it, None)
            acc.add(chunk)
            nf += chunk.nr_frags
    return acc, nf


def pat2beta(pat_path, out_dir=".", genome=None, lbeta=False, backend="cuda",
             out_path=None, chunk_bytes=DEF_CHUNK_BYTES, device="cuda",
             timings=None):
    """Convert a pat[.gz] file to a beta/lbeta file on `device` ('cuda'
    raises without CUDA; 'cpu' runs the kernels' plain twins). Returns the
    output path. With `timings` (a dict), the seconds of each stage
    (decode wait, stage, h2d, kernel, saturate_fetch, write) accumulate
    there; the device is synchronized at the end of each device stage, and
    the decode lookahead runs as it does untimed."""
    g = genome if genome is not None else Genome(None)
    nr_sites = g.get_nr_sites() if hasattr(g, "get_nr_sites") else g.nr_sites

    acc, nf = _accumulate_pat(pat_path, nr_sites, device, backend=backend,
                              chunk_bytes=chunk_bytes, timings=timings)
    beta = acc.finalize(lbeta)
    suff = ".lbeta" if lbeta else ".beta"
    if out_path is None:
        out_path = op.join(out_dir, splitextgz(op.basename(pat_path))[0] + suff)
    with timed(timings, "write", None):
        beta.tofile(out_path)
    logger.info("pat2beta: %s -> %s (%d frags, %d sites, %s)", pat_path,
                out_path, nf, nr_sites, acc.device)
    return out_path


def pat2beta_counts(pat_path, nr_sites, backend="cuda", device="cuda"):
    """Raw (nr_sites, 2) int64 counts (before saturation) of a pat file."""
    acc, _ = _accumulate_pat(pat_path, nr_sites, device, backend=backend)
    return acc.result()
