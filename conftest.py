"""pytest start-up for the repo: build the JAX package's native library
(native/build/libwgbsio.so) once, whole, before any test module is
imported.

Two of the JAX package's test modules call wgbs_tools_tpu.native.get_lib()
while pytest imports them, and get_lib() compiles the library in place
when it is missing or stale. In a fresh checkout, pytest-xdist workers did
that at once into the one file, and a worker that loaded a half-written
library skipped those modules for the whole run. Here the build runs in
the xdist controller (or in the only process, without xdist) before any
worker starts, under a lock and through a rename
(tests/native_oracle.py::build_library), so each worker finds a whole
library newer than its sources and get_lib() loads it without g++.

This file imports no jax, and nothing that imports jax: tests/conftest.py
sets JAX_PLATFORMS after it has run. With WGBS_TPU_NO_NATIVE set it does
nothing.
"""

import importlib.util
import os
import os.path as op
import sys


def _native_oracle():
    name = "native_oracle"
    if name not in sys.modules:
        path = op.join(op.dirname(op.abspath(__file__)), "tests",
                       name + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def pytest_configure(config):
    if hasattr(config, "workerinput") or os.environ.get("WGBS_TPU_NO_NATIVE"):
        return
    _native_oracle().build_library()
