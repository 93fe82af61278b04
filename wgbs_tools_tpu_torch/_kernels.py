"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

nvcc compiles every source into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. The build runs at the first CUDA use, never at import, into
`build/` beside this file, and runs again when a source is newer than the
library. A failed build raises with nvcc's output: there is no fallback.

Every C entry point returns a cudaError_t (0 = success) from
cudaGetLastError() right after its launch; `check` turns a nonzero code
into a RuntimeError naming the call. No entry point sets the CUDA device:
the caller makes the tensors' device current around the call.
"""

import ctypes
import glob
import os
import os.path as op
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = op.dirname(op.abspath(__file__))
_CSRC = op.join(_PKG_DIR, "csrc")
BUILD_DIR = op.join(_PKG_DIR, "build")
_SO = op.join(BUILD_DIR, "libwgbs_kernels.so")
BUILD_LOG = op.join(BUILD_DIR, "nvcc.log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def build(force=False):
    """Compile csrc/*.cu into the shared library if it is missing or older
    than a source. Returns the library path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    newest = max(op.getmtime(s) for s in srcs)
    if not force and op.isfile(_SO) and op.getmtime(_SO) >= newest:
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: a concurrent loader never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + srcs
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(BUILD_LOG, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _SO)
    return _SO


def _bind(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # (c0, c1, meta, <planes>, out, num_tiles, window_len, tile_sb, rc,
    #  g_max, stream): one plane pointer (rows), or two (mv, cv)
    for name, n_planes in (("pileup_flat_vals_fused", 1),
                           ("pileup_flat_classic", 1),
                           ("pileup_flat_vals", 2),
                           ("pileup_flat_vals_add", 2)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * (4 + n_planes) + [i64] * 5 + [vp]
        fn.restype = i32
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
