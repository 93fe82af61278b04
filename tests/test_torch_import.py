"""The port imports without jax, without the JAX package and without
pandas, and refuses devices it has no path for."""

import ast
import os.path as op
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = op.dirname(op.dirname(op.abspath(__file__)))

# a meta-path finder that fails any import of jax, jaxlib, the JAX package
# (wgbs_tools_tpu and its submodules) or pandas (the machine with the card
# has none), then every module of the port; run in a fresh interpreter
# because this test process (conftest.py) has imported jax already
_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

def blocked(name):
    return (name in ("jax", "jaxlib", "wgbs_tools_tpu", "pandas")
            or name.startswith(("jax.", "jaxlib.", "wgbs_tools_tpu.",
                                "pandas.")))

class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import wgbs_tools_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    wgbs_tools_tpu_torch.__path__, "wgbs_tools_tpu_torch."))
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if blocked(m)]
assert not loaded, loaded
# matplotlib is imported only when a figure is asked for
assert not [m for m in sys.modules if m.split(".")[0] == "matplotlib"]
print(" ".join(names))
"""


def test_port_imports_without_jax_and_pandas():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # every module of the port was imported, not an empty walk
    names = set(r.stdout.split())
    assert len(names) >= 66
    assert {"wgbs_tools_tpu_torch.parallel.mesh",
            "wgbs_tools_tpu_torch.parallel.sharded",
            "wgbs_tools_tpu_torch.parallel.multihost",
            "wgbs_tools_tpu_torch.ops.pileup_v1",
            "wgbs_tools_tpu_torch.ops.pileup_v2",
            "wgbs_tools_tpu_torch.utils",
            "wgbs_tools_tpu_torch.native",
            "wgbs_tools_tpu_torch.formats.pat",
            "wgbs_tools_tpu_torch.formats.bgzf",
            "wgbs_tools_tpu_torch.formats.beta",
            "wgbs_tools_tpu_torch.genome.refdir",
            "wgbs_tools_tpu_torch.genome.cpg_index",
            "wgbs_tools_tpu_torch.genome.region",
            "wgbs_tools_tpu_torch.formats.blocks",
            "wgbs_tools_tpu_torch.formats.csi",
            "wgbs_tools_tpu_torch.models.segment",
            "wgbs_tools_tpu_torch.ops.maxplus",
            "wgbs_tools_tpu_torch.cli.cmd_segment",
            "wgbs_tools_tpu_torch.models.segment_exact_device",
            "wgbs_tools_tpu_torch.ops.segment_exact",
            "wgbs_tools_tpu_torch.ops.dp_scan",
            "wgbs_tools_tpu_torch.flagship",
            "wgbs_tools_tpu_torch.ops.reduceat",
            "wgbs_tools_tpu_torch.ops.pairs",
            "wgbs_tools_tpu_torch.ops.frag_ops",
            "wgbs_tools_tpu_torch.pipeline.pat_stream",
            "wgbs_tools_tpu_torch.cli.cmd_beta",
            "wgbs_tools_tpu_torch.cli.cmd_misc",
            "wgbs_tools_tpu_torch.cli.cmd_homog",
            "wgbs_tools_tpu_torch.ops.calling",
            "wgbs_tools_tpu_torch.pipeline.bam",
            "wgbs_tools_tpu_torch.pipeline.nanopore",
            "wgbs_tools_tpu_torch.pipeline.calling",
            "wgbs_tools_tpu_torch.pipeline.bam_columnar",
            "wgbs_tools_tpu_torch.pipeline.bam_columnar_ont",
            "wgbs_tools_tpu_torch.pipeline.bam_stream",
            "wgbs_tools_tpu_torch.pipeline.bam2pat_run",
            "wgbs_tools_tpu_torch.cli.cmd_pat",
            "wgbs_tools_tpu_torch.cli.cmd_bam2pat",
            "wgbs_tools_tpu_torch.pipeline.bam_split",
            "wgbs_tools_tpu_torch.models.markers",
            "wgbs_tools_tpu_torch.models.bimodal",
            "wgbs_tools_tpu_torch.cli.cmd_markers",
            "wgbs_tools_tpu_torch.cli.view",
            "wgbs_tools_tpu_torch.cli.cmd_view",
            "wgbs_tools_tpu_torch.cli.main",
            "wgbs_tools_tpu_torch.genome.init_genome",
            "wgbs_tools_tpu_torch.genome.annotations",
            "wgbs_tools_tpu_torch.formats.bigwig",
            "wgbs_tools_tpu_torch.cli.cmd_genome",
            "wgbs_tools_tpu_torch.cli.cmd_convert",
            "wgbs_tools_tpu_torch.cli.cmd_vis",
            "wgbs_tools_tpu_torch.cli.worker"} <= names


def test_new_commands_run_without_jax_and_pandas(tmp_path):
    """The slice's commands run (their lazy imports too) with jax, the JAX
    package and pandas blocked: find_markers, test_bimodal, view, merge,
    mask_pat and frag_len on a two-site genome, on the CPU."""
    script = _BLOCKED_IMPORT.split("import wgbs_tools_tpu_torch")[0] + r'''
import os, sys
import numpy as np
root = sys.argv[1]
os.environ["WGBS_TPU_REFDIR"] = os.path.join(root, "refs")
g = os.path.join(root, "refs", "g")
os.makedirs(g)
np.savez(os.path.join(g, "cpg_index.npz"), loci=np.array([10, 20, 30, 40],
         dtype=np.int32), chrom_offsets=np.array([0, 4]),
         chrom_sizes=np.array([100]))
import json
json.dump({"chroms": ["chr1"], "name": "g"},
          open(os.path.join(g, "cpg_index.json"), "w"))
from wgbs_tools_tpu_torch.cli.main import main
from wgbs_tools_tpu_torch.formats.pat import PatFrags, write_pat
codes = np.array([[1, 1, 0], [0, 0, 3]], dtype=np.uint8)
write_pat(PatFrags(np.array([1, 2], np.int32), np.array([3, 2], np.int32),
                   np.array([2, 1], np.int32), codes,
                   np.array([0, 0], np.int16), ["chr1"]),
          os.path.join(root, "a.pat.gz"))
bed = os.path.join(root, "b.bed")
open(bed, "w").write("chr1\t9\t21\t1\t3\nchr1\t29\t41\t3\t5\n")
for beta, rows in (("s1", [[0, 9], [1, 9], [8, 9], [9, 9]]),
                   ("s2", [[9, 9], [8, 9], [0, 9], [1, 9]])):
    np.array(rows, dtype=np.uint8).tofile(os.path.join(root, beta + ".beta"))
open(os.path.join(root, "g.csv"), "w").write("name,group\ns1,A\ns2,B\n")
G = ["--genome", "g"]
out = os.path.join(root, "o")
os.makedirs(out)
assert main(["view", os.path.join(root, "a.pat.gz"), "-o",
             os.path.join(out, "v.pat")] + G) == 0
assert main(["merge", os.path.join(root, "a.pat.gz"), os.path.join(root,
             "a.pat.gz"), "-p", os.path.join(out, "m")] + G) == 0
assert main(["mask_pat", os.path.join(root, "a.pat.gz"), "-b", bed, "-p",
             os.path.join(out, "mk"), "--beta", "--device", "cpu"] + G) == 0
assert main(["frag_len", os.path.join(root, "a.pat.gz"), "--out_path",
             os.path.join(out, "h.txt")] + G) == 0
assert main(["test_bimodal", os.path.join(root, "a.pat.gz"), "-s", "1-4",
             "-o", os.path.join(out, "bi.tsv")] + G) == 0
assert main(["find_markers", "-b", bed, "-g", os.path.join(root, "g.csv"),
             "--betas", os.path.join(root, "s1.beta"),
             os.path.join(root, "s2.beta"), "-o", out, "--device", "cpu",
             "-c", "1", "--delta_means", "0.5"]) == 0
loaded = [m for m in sys.modules if blocked(m)]
assert not loaded, loaded
print(sorted(os.listdir(out)))
'''
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    for name in ("v.pat", "m.pat.gz", "mk.pat.gz", "mk.beta", "h.txt",
                 "bi.tsv", "Markers.A.bed", "params.txt"):
        assert name in r.stdout, (name, r.stdout)


def test_last_commands_run_without_jax_pandas_and_matplotlib(tmp_path):
    """The last slice's commands run (their lazy imports too) with jax, the
    JAX package, pandas and matplotlib blocked, in their text modes:
    init_genome and set_default_ref of a FASTA written here, convert,
    beta2bed, beta2bw, beta_cov -L, beta_stats, bed2beta, lbeta2beta,
    beta_to_450k, compare_betas and vis, on the CPU."""
    script = _BLOCKED_IMPORT.split("import wgbs_tools_tpu_torch")[0] \
        .replace('"pandas")', '"pandas", "matplotlib")') \
        .replace('"pandas.")', '"pandas.", "matplotlib.")') + r'''
import gzip, os, sys
import numpy as np
root = sys.argv[1]
os.environ["WGBS_TPU_REFDIR"] = os.path.join(root, "refs")
rng = np.random.default_rng(3)
fa = os.path.join(root, "g.fa")
with open(fa, "w") as f:
    for c, n in (("chr1", 4000), ("chr2", 2000)):
        seq = "".join(rng.choice(list("ACGT"), n)) + "CG" * 20
        f.write(f">{c}\n{seq}\n")
from wgbs_tools_tpu_torch.cli.main import main
assert main(["init_genome", "g", "--fasta_path", fa]) == 0
assert main(["init_genome", "h", "--fasta_path", fa, "--no_default"]) == 0
assert main(["set_default_ref", "h"]) == 0
assert main(["set_default_ref", "g"]) == 0
from wgbs_tools_tpu_torch.genome.refdir import Genome
n = Genome().get_nr_sites()
cov = rng.integers(0, 30, n)
beta = os.path.join(root, "a.beta")
np.stack([cov // 2, cov], 1).astype(np.uint8).tofile(beta)
np.stack([cov // 3, cov], 1).astype(np.uint8).tofile(
    os.path.join(root, "b.beta"))
np.stack([cov, cov * 40], 1).astype(np.uint16).tofile(
    os.path.join(root, "c.lbeta"))
with gzip.open(os.path.join(root, "refs", "g", "ilmn2CpG.tsv.gz"), "wt") as f:
    f.write("cg00000001\t3\ncg00000002\t9\n")
out = os.path.join(root, "o")
os.makedirs(out)
bed = os.path.join(root, "x.bed")
open(bed, "w").write("chr1\t10\t900\nchr2\t5\t700\n")
assert main(["convert", "-L", bed, "-o", os.path.join(out, "x5.bed")]) == 0
x5 = os.path.join(out, "x5.bed")
assert main(["convert", "-r", "chr1:100-900"]) == 0
assert main(["convert", "--array_id", "cg00000002"]) == 0
assert main(["beta2bed", beta, "-L", x5, "-o",
             os.path.join(out, "a.bed")]) == 0
assert main(["beta2bw", beta, "-o", out, "--cov"]) == 0
assert main(["beta_cov", beta, "-L", x5, "--device", "cpu"]) == 0
assert main(["beta_stats", beta, "-r", "chr2"]) == 0
assert main(["bed2beta", os.path.join(out, "a.bed"), "-o", out,
             "--add_one"]) == 0
assert main(["lbeta2beta", os.path.join(root, "c.lbeta"), "-o", out]) == 0
assert main(["beta_to_450k", beta, "-o", os.path.join(out, "a.csv")]) == 0
assert main(["compare_betas", beta, os.path.join(root, "b.beta")]) == 0
assert main(["vis", beta, "-s", "3-30", "--no_color"]) == 0
loaded = [m for m in sys.modules if blocked(m)]
assert not loaded, loaded
print(sorted(os.listdir(out)))
'''
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    for name in ("x5.bed", "a.bed", "a.bigwig", "a.cov.bigwig", "a.beta",
                 "c.beta", "a.csv"):
        assert name in r.stdout, (name, r.stdout)


def _imported_modules(path):
    """Every module an `import` or `from ... import` in the file names
    (relative imports as written, with their leading dots)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    return names


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py runs where the JAX package is not the code under test:
    its imports reach the port (wgbs_tools_tpu_torch), never jax nor
    wgbs_tools_tpu."""
    names = _imported_modules(op.join(REPO, "chip_smoke.py"))
    assert "wgbs_tools_tpu_torch.ops.pileup" in names  # not an empty parse
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "wgbs_tools_tpu")]
    assert not bad, bad


def test_kernel_ab_imports_nothing_of_the_jax_package():
    """kernel_ab.py, the A/B of two trees' code-word kernels on the card,
    imports the port and chip_smoke.py only, never jax nor wgbs_tools_tpu."""
    names = _imported_modules(op.join(REPO, "kernel_ab.py"))
    assert "chip_smoke" in names and "wgbs_tools_tpu_torch.ops" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "wgbs_tools_tpu")]
    assert not bad, bad


def test_kernel_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain twin; tensors on any other device go
    to the kernel launcher, which accepts CUDA alone and raises."""
    from wgbs_tools_tpu_torch.ops.pileup_v3 import (Staged, flat_classic,
                                                    flat_vals, flat_vals_add,
                                                    flat_vals_fused)

    dev = torch.device("meta")

    def staged(form, dtype, width, cv=None):
        return Staged(form,
                      torch.zeros(2, dtype=torch.int32, device=dev),
                      torch.zeros(2, dtype=torch.int32, device=dev),
                      torch.zeros((16, 2, 8), dtype=torch.int32, device=dev),
                      torch.zeros((128, width), dtype=dtype, device=dev),
                      128, 8, 1, cv)

    split = staged("vals_split", torch.uint8, 128,
                   torch.zeros((128, 128), dtype=torch.uint8, device=dev))
    total = torch.zeros((200, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        flat_vals_fused(staged("vals", torch.uint8, 256), 200)
    with pytest.raises(ValueError, match="CUDA"):
        flat_classic(staged("classic", torch.int32, 8), 200)
    with pytest.raises(ValueError, match="CUDA"):
        flat_vals(split, 200)
    for st in (split, staged("vals", torch.uint8, 256)):
        with pytest.raises(ValueError, match="CUDA"):
            flat_vals_add(total, st, 200)
    assert flat_vals_fused.launches == 0 and flat_classic.launches == 0
    assert flat_vals.launches == 0 and flat_vals_add.launches == 0


def test_maxplus_closure_refuses_other_devices():
    """The max-plus closure's wrapper, like the pileup wrappers: a tensor
    on a device other than the CPU goes to the launcher, which raises."""
    from wgbs_tools_tpu_torch.ops.maxplus import maxplus_closure

    with pytest.raises(ValueError, match="CUDA"):
        maxplus_closure(torch.zeros((3, 129, 129), device="meta"), 7)
    assert maxplus_closure.launches == 0


def test_segment_exact_dp_refuses_other_devices():
    """The exact DP's wrapper, like the others: a tensor on a device other
    than the CPU goes to the launcher, which raises; the route refuses such
    a device before it reads anything."""
    from wgbs_tools_tpu_torch.models.segment_exact_device import \
        segment_exact_device_T
    from wgbs_tools_tpu_torch.ops.segment_exact import segment_exact_dp

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        segment_exact_dp(z(2, 3, 101), z(2, 3, 101), z(2, 100),
                         z(2080, dtype=torch.float32), 64, 2000)
    assert segment_exact_dp.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        segment_exact_device_T([[[1, 2]] * 10], list(range(10)), 8, 2000,
                               15.0, device="meta")


def test_dp_scan_refuses_other_devices():
    """The analysis step's DP wrapper, like the others: a tensor on a
    device other than the CPU goes to the launcher, which raises."""
    from wgbs_tools_tpu_torch.ops.dp_scan import dp_scan

    with pytest.raises(ValueError, match="CUDA"):
        dp_scan(torch.zeros((2, 100, 64), device="meta"), 64)
    assert dp_scan.launches == 0


def test_block_and_read_wrappers_refuse_other_devices():
    """block_sums, pair_counts_add and homog_bins, like the others: tensors
    on a device other than the CPU go to the launcher, which raises."""
    from wgbs_tools_tpu_torch.ops.frag_ops import homog_bins
    from wgbs_tools_tpu_torch.ops.pairs import pair_counts_add
    from wgbs_tools_tpu_torch.ops.reduceat import block_sums

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        block_sums(z(100, 2, dtype=torch.uint8), z(5, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        pair_counts_add(z(100, 4), z(7), z(7), z(7), z(7, 5,
                                                       dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        homog_bins(z(5, 3, dtype=torch.int64), z(7, 5, dtype=torch.uint8),
                   z(7), z(7), z(7), z(5, dtype=torch.int64),
                   z(5, dtype=torch.int64), z(9), z(9),
                   z(4, dtype=torch.float32), 3, False)
    assert block_sums.launches == 0 and pair_counts_add.launches == 0
    assert homog_bins.launches == 0


def test_calling_wrappers_refuse_other_devices():
    """call_reads and merge_pe, like the others: tensors on a device other
    than the CPU go to the launcher, which raises; the device entry points
    refuse such a device before they read anything."""
    import numpy as np

    from wgbs_tools_tpu_torch.ops.calling import (call_reads,
                                                  call_reads_device,
                                                  merge_pe, merge_pe_device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        call_reads(z(4, 8, dtype=torch.uint8), z(4), z(4),
                   z(4, dtype=torch.uint8), z(9), 0, 3)
    with pytest.raises(ValueError, match="CUDA"):
        merge_pe(z(4, dtype=torch.int64), z(4), z(4, 6, dtype=torch.uint8),
                 z(4, dtype=torch.int64), z(4), z(4, 5, dtype=torch.uint8))
    assert call_reads.launches == 0 and merge_pe.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        call_reads_device(np.ones(2, np.int64), np.zeros(2, np.int64), True,
                          np.arange(5, dtype=np.int32), 1,
                          np.zeros((2, 4), np.uint8), np.full(2, 4),
                          device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        merge_pe_device(np.ones(2, np.int64), np.zeros((2, 1), np.uint8),
                        np.ones(2, np.int64), np.ones(2, np.int64),
                        np.zeros((2, 1), np.uint8), np.ones(2, np.int64),
                        device="meta")


def test_new_kernel_wrappers_refuse_other_devices():
    """The same for flat_lc, tiled_classic, tiles_v2 and tiles_v1."""
    from wgbs_tools_tpu_torch.ops.pileup_v1 import StagedV1, tiles_v1
    from wgbs_tools_tpu_torch.ops.pileup_v2 import StagedV2, tiles_v2
    from wgbs_tools_tpu_torch.ops.pileup_v3 import (Staged, flat_lc,
                                                    tiled_classic)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device="meta")

    lane = Staged("lane", z(2), z(2), z(16, 2, 8), z(128, 8), 128, 8, 1,
                  cnts=z(128, 32), max_chunks=1)
    classic = Staged("classic", z(2), z(2), z(16, 2, 8), z(128, 8), 128, 8,
                     1, max_chunks=1)
    for call in (lambda: flat_lc(lane, 200),
                 lambda: tiled_classic(classic, 200),
                 lambda: tiles_v2(StagedV2(z(1), z(1), z(16, 3, 256),
                                           z(16 * 256, 2)), 200),
                 lambda: tiles_v1(StagedV1(z(1), z(1), z(1, 4, 256),
                                           z(256, 8)), 200)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert flat_lc.launches == tiled_classic.launches == 0
    assert tiles_v2.launches == tiles_v1.launches == 0


def test_resolve_device_raises_without_cuda(monkeypatch):
    from wgbs_tools_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
