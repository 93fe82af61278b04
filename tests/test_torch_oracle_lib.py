"""The JAX package's native library, which the port's tests hold the port
to, built once for all the test processes.

wgbs_tools_tpu.native.get_lib() compiles native/*.cpp with g++ straight
into native/build/libwgbsio.so when that file is missing or stale, and
returns None for the rest of the process if the build or the load fails.
pytest-xdist workers import the test modules together, so in a fresh
checkout several of them ran g++ into that one path at once, and a worker
that loaded a half-written library skipped whole modules: the pass count
depended on the run. oracle_lib() builds under a lock, into a private name
that is then renamed into place, so a loader only ever sees a whole
library, and only then asks get_lib() for it.
"""

import fcntl
import os
import os.path as op
import subprocess
import tempfile

import pytest

from wgbs_tools_tpu import native as jnat


def _stale():
    return (not op.isfile(jnat._SO) or op.getmtime(jnat._SO)
            < max(op.getmtime(s) for s in jnat._SRCS))


def _build(force):
    """Compile the library with the JAX package's own g++ command into a
    private name, then rename it into place, under a lock in native/build/;
    unless force, only where it is missing or stale. False where g++ (or
    zlib) fails."""
    os.makedirs(jnat._BUILD_DIR, exist_ok=True)
    with open(op.join(jnat._BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (force or _stale()):
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
    """wgbs_tools_tpu.native.get_lib(), after building its library where it
    is missing or older than its sources: one process builds while the
    others wait, then each loads the finished file. get_lib() itself still
    compiles in place when a module calls it before this (the JAX package's
    tests do, while they are imported), so a library that does not load is
    built once more, whole, and loaded again. None, as get_lib() gives,
    where WGBS_TPU_NO_NATIVE is set or the library does not build."""
    if jnat._LIB is not None or os.environ.get("WGBS_TPU_NO_NATIVE"):
        return jnat.get_lib()
    for force in (False, True):
        if not _build(force):
            break
        # a get_lib() of this process that ran into another's build gave
        # up for the process: the library is whole now
        jnat._TRIED = False
        if jnat.get_lib() is not None:
            break
    return jnat.get_lib()


@pytest.mark.skipif(bool(os.environ.get("WGBS_TPU_NO_NATIVE")),
                    reason="WGBS_TPU_NO_NATIVE switches the library off")
def test_oracle_lib_loads_and_is_newer_than_its_sources():
    lib = oracle_lib()
    assert lib is not None and lib is jnat.get_lib()
    assert not _stale()
    assert callable(lib.pat_pileup)
