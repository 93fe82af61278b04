"""The JAX package's native library, which the port's tests hold the port
to, loads and is newer than its sources. The build under a lock, and the
loader the port's test modules import from here (`oracle_lib`), are in
native_oracle.py; the repo's root conftest.py builds the library once
before any test process imports a test module.
"""

import os

import pytest

from native_oracle import _stale, oracle_lib  # noqa: F401 (re-exported)
from wgbs_tools_tpu import native as jnat


@pytest.mark.skipif(bool(os.environ.get("WGBS_TPU_NO_NATIVE")),
                    reason="WGBS_TPU_NO_NATIVE switches the library off")
def test_oracle_lib_loads_and_is_newer_than_its_sources():
    lib = oracle_lib()
    assert lib is not None and lib is jnat.get_lib()
    assert not _stale()
    assert callable(lib.pat_pileup)
