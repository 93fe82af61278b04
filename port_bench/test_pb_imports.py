"""Nothing the benchmark runs loads jax or the JAX package, and the plain
references load nothing of the port. Names are compared by their whole
top-level part: wgbs_tools_tpu_torch begins with wgbs_tools_tpu."""

import ast
import glob
import os.path as op
import subprocess
import sys

import pytest

HERE = op.dirname(op.abspath(__file__))
ROOT = op.dirname(HERE)

BLOCK = """
import sys
class Block:
    def __init__(self, names): self.names = set(names)
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in self.names:
            raise ImportError("blocked: " + fullname)
        return None
sys.meta_path.insert(0, Block({names!r}))
sys.path.insert(0, {root!r})
"""

RUN_CELL = """
import json
from port_bench import run
from port_bench.conftest import small_cell
cell = small_cell({name!r}, n_sites=12_000, frags=3_000, chunk=3_000)
r = run.run_cell(cell, 2**33 + 5, 0.01, device="cpu")
assert r["correct"], r
assert not run.forbidden_modules(), run.forbidden_modules()
print("OK", json.dumps(r["checks"]))
"""


def _python(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=600)


@pytest.mark.parametrize("name", ["pat2beta.pe150", "segment.exact",
                                  "segment.fast", "pat2beta.ont_long"])
def test_cell_runs_without_jax(name):
    code = BLOCK.format(names=["jax", "jaxlib", "flax", "wgbs_tools_tpu"],
                        root=ROOT) + RUN_CELL.format(name=name)
    out = _python(code)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


def test_references_import_no_port():
    refs = sorted(glob.glob(op.join(HERE, "configs", "*.py")))
    assert refs
    for path in refs:
        tree = ast.parse(open(path).read())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, path
                tops.add(node.module.split(".")[0])
        assert tops <= {"numpy", "torch"}, (path, tops)
    code = BLOCK.format(names=["jax", "jaxlib", "flax", "wgbs_tools_tpu",
                               "wgbs_tools_tpu_torch", "port_bench"],
                        root=ROOT) + "\n".join(
        f"import importlib.util as u; s = u.spec_from_file_location('r{i}', "
        f"{p!r}); m = u.module_from_spec(s); s.loader.exec_module(m)"
        for i, p in enumerate(refs)) + "\nprint('OK')"
    out = _python(code)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


def test_forbidden_names_compare_whole():
    from port_bench import run

    sys.modules.setdefault("wgbs_tools_tpu_torch", sys.modules[__name__])
    assert "wgbs_tools_tpu" not in run.forbidden_modules() or \
        "wgbs_tools_tpu" in {m.split(".")[0] for m in sys.modules}
