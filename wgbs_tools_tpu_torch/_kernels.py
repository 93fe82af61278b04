"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

nvcc compiles every source into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. The sources compile in parallel, one nvcc each, and one more nvcc
links them. The build runs at the first CUDA use, never at import, into
`build/` beside this file, and runs again when a source or header is newer
than the library. A failed build raises with nvcc's output: there is no
fallback.

Every C entry point returns a cudaError_t (0 = success) from
cudaGetLastError() right after its launch; `check` turns a nonzero code
into a RuntimeError naming the call. No entry point sets the CUDA device:
`launch` makes the tensors' device current around the call.
"""

import ctypes
import glob
import os
import os.path as op
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG_DIR = op.dirname(op.abspath(__file__))
_CSRC = op.join(_PKG_DIR, "csrc")
BUILD_DIR = op.join(_PKG_DIR, "build")
_SO = op.join(BUILD_DIR, "libwgbs_kernels.so")
BUILD_LOG = op.join(BUILD_DIR, "nvcc.log")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v"]

_LIB = None
_LOCK = threading.Lock()


def sources():
    return sorted(glob.glob(op.join(_CSRC, "*.cu")))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = op.join(home, "bin", "nvcc")
    if op.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): cannot build the "
                           "CUDA kernels")
    return found


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return cmd, proc.returncode, proc.stdout + proc.stderr


def build(force=False):
    """Compile csrc/*.cu into the shared library if it is missing or older
    than a source or header. Returns the library path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    newest = max(op.getmtime(s) for s in srcs +
                 glob.glob(op.join(_CSRC, "*.cuh")))
    if not force and op.isfile(_SO) and op.getmtime(_SO) >= newest:
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library go to private names, then the library is
    # renamed: a concurrent loader never sees a half-written library
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [op.join(tmpdir, op.basename(s)[: -len(".cu")] + ".o")
                for s in srcs]
        with ThreadPoolExecutor(len(srcs)) as ex:
            runs = list(ex.map(_run, ([nvcc] + NVCC_FLAGS + ["-c", "-o", o, s]
                                      for s, o in zip(srcs, objs))))
        tmp_so = op.join(tmpdir, "lib.so")
        if all(rc == 0 for _, rc, _ in runs):
            runs.append(_run([nvcc] + _ARCH + ["-shared", "-o", tmp_so]
                             + objs))
        with open(BUILD_LOG, "w") as f:
            for cmd, _, out in runs:
                f.write(" ".join(cmd) + "\n" + out)
        for cmd, rc, out in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed (exit {rc}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        os.replace(tmp_so, _SO)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return _SO


def _bind(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # (<n_ptr device pointers>, <n_int int64 scalars>, stream)
    for name, n_ptr, n_int in (
            # v3: (c0, c1, meta, <planes>, out), (num_tiles, window_len,
            # tile_sb, rc, g_max[, n_chunks])
            ("pileup_flat_vals_fused", 5, 5),
            ("pileup_flat_classic", 5, 5),
            ("pileup_flat_vals", 6, 5),
            ("pileup_flat_vals_add", 6, 5),
            ("pileup_flat_lc", 6, 5),
            ("pileup_tiled_classic", 5, 6),
            # v2: (c0, c1, meta, words, out), (num_tiles, window_len, tile,
            # fc, g_max, w_cols)
            ("pileup_tiles_v2", 5, 6),
            # v1: (lo, hi, meta, words, out), (num_tiles, window_len, tile,
            # fc, w16)
            ("pileup_tiles_v1", 5, 5),
            # max-plus closure: (S0, out, sched), (nb, n, steps)
            ("maxplus_closure", 3, 3),
            # exact segmentation: (pm, pt, loci, tbl, ks, ring), (B, K, n,
            # Wb, max_bp, tbl_size)
            ("segment_exact_dp", 6, 6),
            # the analysis step's serial DP: (C, ks, scratch), (nb, n, W)
            ("dp_scan", 3, 3),
            # block sums: (data, bounds, out, scratch), (B, N, itemsize,
            # list_long)
            ("block_sums", 4, 4),
            # pair counts: (start_rel, length, count, codes, table), (F, L,
            # n)
            ("pair_counts", 5, 3),
            # homog bins: (codes, fstart, flen, fcount, bstart, bend, fi,
            # bi, ranges, out[, stats]), (P, L, nbins, min_cpgs, inclusive)
            ("homog_bins", 10, 5), ("homog_bins_stats", 11, 5),
            # bam2pat's calling: (seq, lens, pos1, bottom, loci, first_k,
            # span, packed[, paths]), (R, L, n_loci, KB, clip)
            ("call_reads", 8, 5), ("call_reads_paths", 9, 5),
            # mate merging: (s1, sp1, p1, s2, sp2, p2, start, span, packed,
            # too_long), (n, S1, S2)
            ("merge_pe", 10, 3)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + [i64] * n_int + [vp]
        fn.restype = i32
    # (Wb, int64 out[5]): segment_exact_dp's launch and its CTAs per SM
    lib.segment_exact_dp_occupancy.argtypes = [i64, vp]
    lib.segment_exact_dp_occupancy.restype = i32
    # (n, W, int64 out[4]): dp_scan's body, scratch, threads, shared bytes
    lib.dp_scan_plan.argtypes = [i64, i64, vp]
    lib.dp_scan_plan.restype = i32
    # (S1, S2, int64 out[3]): merge_pe's body (0 staged, 1 gather), pairs a
    # tile and dynamic shared bytes
    lib.merge_pe_plan.argtypes = [i64, i64, vp]
    lib.merge_pe_plan.restype = i32
    lib.wgbs_cuda_error_string.argtypes = [i32]
    lib.wgbs_cuda_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library, building it first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _LIB = lib
    return _LIB


def check(err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load().wgbs_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_cuda(name, device):
    """Raise unless `device` is a CUDA device (before anything loads the
    library)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}; the kernel takes CUDA "
                         "tensors and its plain twin CPU tensors")


def launch(name, device, *args):
    """Call the C entry point `name` with `args` (data pointers, then int
    scalars) and the current stream of `device`, with `device` made current
    for the call only, by PyTorch's own guard: the C side never sets a
    device, so the caller's current device is what it was, and a per-device
    shared-memory attribute is set on the right device. Raises on a device
    other than CUDA and on a CUDA error."""
    require_cuda(name, device)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    check(err, name)
