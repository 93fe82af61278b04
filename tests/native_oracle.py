"""The JAX package's native library, which the port's tests hold the port
to, built once for all the test processes.

wgbs_tools_tpu.native.get_lib() compiles native/*.cpp with g++ straight
into native/build/libwgbsio.so when that file is missing or stale, and
returns None for the rest of the process if the build or the load fails.
pytest-xdist workers import the test modules together, and two of the JAX
package's test modules (test_pileup_tpu3.py, test_bam_stream.py) call
get_lib() while they are imported, so in a fresh checkout several workers
ran g++ into that one path at once, and a worker that loaded a
half-written library skipped whole modules: the pass count depended on the
run. build_library() builds under a lock, into a private name that is
then renamed into place, so a loader only ever sees a whole library. The
repo's root conftest.py calls it once, before any worker starts, so
get_lib() only ever finds a whole library.

This module imports no jax: wgbs_tools_tpu.native needs numpy and ctypes
only.
"""

import fcntl
import os
import os.path as op
import subprocess
import tempfile

from wgbs_tools_tpu import native as jnat


def _stale():
    return (not op.isfile(jnat._SO) or op.getmtime(jnat._SO)
            < max(op.getmtime(s) for s in jnat._SRCS))


def _build():
    """Compile the library with the JAX package's own g++ command into a
    private name, then rename it into place, under a lock in native/build/;
    only where it is missing or stale. False where g++ (or zlib) fails."""
    os.makedirs(jnat._BUILD_DIR, exist_ok=True)
    with open(op.join(jnat._BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return True
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=jnat._BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp]
                           + jnat._SRCS + ["-lz", "-lpthread"], check=True,
                           capture_output=True)
            os.replace(tmp, jnat._SO)
        except (OSError, subprocess.CalledProcessError):
            return False
        finally:
            if op.exists(tmp):
                os.remove(tmp)
    return True


def oracle_lib():
    """wgbs_tools_tpu.native.get_lib() after build_library() (a no-op
    where the library is whole and fresh, as the root conftest.py leaves
    it). None, as get_lib() gives, where WGBS_TPU_NO_NATIVE is set or the
    library does not build."""
    build_library()
    return jnat.get_lib()


def build_library():
    """The library built (where missing or stale) under the lock; False
    where g++ fails. Nothing where WGBS_TPU_NO_NATIVE is set."""
    if os.environ.get("WGBS_TPU_NO_NATIVE"):
        return False
    return _build()
