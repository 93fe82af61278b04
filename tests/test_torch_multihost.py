"""Multi-process pat2beta and segment of the port (parallel/multihost.py):
N worker processes join one torch.distributed (gloo) job over 127.0.0.1.
pat2beta: each piles up its own site range and writes its byte range; the
beta equals the JAX package's single-process bytes. segment: the chunks
are round-robined over the ranks and rank 0 stitches; the blocks equal
the JAX package's (exact mode) and one process's (fast mode)."""

import os
import os.path as op
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.formats.pat import write_pat  # noqa: E402
from wgbs_tools_tpu.pipeline.pat2beta import (  # noqa: E402
    pat2beta as jax_pat2beta,
)
from wgbs_tools_tpu_torch.parallel.multihost import (  # noqa: E402
    free_port,
    run_pat2beta_multiprocess,
)

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

REPO = op.dirname(op.dirname(op.abspath(__file__)))
WORKER = [sys.executable, "-m", "wgbs_tools_tpu_torch.parallel.multihost"]
TIMEOUT = 180  # seconds for each multi-process run


class _Genome:
    def __init__(self, n):
        self.nr_sites = n

    def get_nr_sites(self):
        return self.nr_sites


def _pat(tmp_path, name, seed, n_frags, n_sites, **kw):
    f = random_frags(np.random.default_rng(seed), n_frags, n_sites, **kw)
    path = str(tmp_path / f"{name}.pat.gz")
    write_pat(f.sort().collapse(), path)
    return path


@pytest.mark.parametrize("lbeta,max_count", [(False, 3), (True, 3000)])
def test_multiprocess_pat2beta_equals_jax(tmp_path, lbeta, max_count):
    n = 4096
    pat = _pat(tmp_path, "mh", 7, 4000, n - 20, max_len=14,
               max_count=max_count)
    want = jax_pat2beta(pat, genome=_Genome(n), lbeta=lbeta, sharded=False,
                        out_path=str(tmp_path / "single"))
    got = run_pat2beta_multiprocess(pat, str(tmp_path / "multi"), n,
                                    num_processes=2, lbeta=lbeta,
                                    device="cpu", timeout=TIMEOUT)
    data = open(got, "rb").read()
    assert len(data) == n * 2 * (2 if lbeta else 1)
    assert data == open(want, "rb").read()


def test_multiprocess_empty_process_range(tmp_path):
    """Every fragment in process 0's site range: the other processes
    stream nothing and still take part in the collectives."""
    n = 4096
    pat = _pat(tmp_path, "e", 11, 800, n // 4 - 20, max_len=10)
    want = jax_pat2beta(pat, genome=_Genome(n), sharded=False,
                        out_path=str(tmp_path / "s.beta"))
    got = run_pat2beta_multiprocess(pat, str(tmp_path / "m.beta"), n,
                                    num_processes=3, device="cpu",
                                    timeout=TIMEOUT)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_cli_procs_equals_jax_cli(tmp_path, mini_genome, capfd):
    """`python -m wgbs_tools_tpu_torch pat2beta --procs 2 --device cpu`
    writes the JAX CLI's bytes; each worker reports its launch counts."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    n = mini_genome.get_nr_sites()
    pat = _pat(tmp_path, "c", 9, 1500, n - 20, max_len=12)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert jax_main(["pat2beta", pat, "-o", str(tmp_path / "j")]) == 0
    assert port_main(["pat2beta", pat, "-o", str(tmp_path / "t"),
                      "--procs", "2", "--device", "cpu"]) == 0
    want = (tmp_path / "j" / "c.beta").read_bytes()
    assert len(want) == 2 * n
    assert (tmp_path / "t" / "c.beta").read_bytes() == want
    err = capfd.readouterr().err
    for r in (0, 1):
        assert f"[wgbs-torch worker {r}] launches {{" in err


def test_multiprocess_worker_fails_the_launch(tmp_path):
    """A worker that exits nonzero fails the launch with its output; asking
    for CUDA without it raises before any worker starts."""
    with pytest.raises(RuntimeError, match="worker .* rc=.*\n.*"):
        run_pat2beta_multiprocess(str(tmp_path / "missing.pat.gz"),
                                  str(tmp_path / "x.beta"), 100,
                                  num_processes=2, device="cpu",
                                  timeout=TIMEOUT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_pat2beta_multiprocess("x.pat.gz", str(tmp_path / "x.beta"),
                                      100, device="cuda")


def test_worker_without_cuda_exits_nonzero(tmp_path):
    """A worker asked for CUDA where there is none raises: it never runs on
    the host on its own."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    pat = _pat(tmp_path, "w", 3, 50, 500, max_len=8)
    r = subprocess.run(
        WORKER + ["--coordinator", f"127.0.0.1:{free_port()}",
                  "--num_processes", "1", "--process_id", "0", "--pat", pat,
                  "--out", str(tmp_path / "w.beta"), "--nr_sites", "500",
                  "--device", "cuda"],
        capture_output=True, text=True, timeout=TIMEOUT,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr + r.stdout


@pytest.mark.parametrize("args", [[], ["--coordinator", "127.0.0.1:1",
                                       "--num_processes", "2",
                                       "--process_id", "2", "--pat", "x",
                                       "--out", "y", "--nr_sites", "5"],
                                  ["--coordinator", "127.0.0.1:1",
                                   "--num_processes", "2", "--process_id",
                                   "0", "--job", "segment"]])
def test_worker_bad_args_exit_2(args):
    r = subprocess.run(WORKER + args, capture_output=True, timeout=TIMEOUT,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 2  # argparse usage error, before any init


# ---------------------------------------------------------------------------
# segment over worker processes (run_segment_multiprocess, segment --procs)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seg_betas(mini_genome, tmp_path_factory):
    """Two betas over the mini genome with methylation blocks, written by
    the JAX package (its test_multiprocess_segment_matches_single's)."""
    from wgbs_tools_tpu.formats.beta import save_beta

    nr = mini_genome.get_nr_sites()
    d = tmp_path_factory.mktemp("mh_seg")
    rng = np.random.default_rng(5)
    paths = []
    for i in range(2):
        cov = rng.integers(0, 20, size=nr).astype(np.int64)
        meth = rng.binomial(cov, 0.2 + 0.6 * ((np.arange(nr) // 400) % 2))
        p = str(d / f"m{i}.beta")
        save_beta(p, np.stack([meth, cov], axis=1))
        paths.append(p)
    return paths, nr


SEG_KW = dict(max_cpg=100, max_bp=100000, pseudo_count=15.0,
              chunk_size=1500)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_multiprocess_segment_equals_jax(tmp_path, mini_genome, seg_betas,
                                         mode):
    """2 processes (chunks round-robined, rank 0 stitches) give the blocks
    of one process: exact mode JAX's segment_ranges' exactly; fast mode
    the port's one-process blocks exactly, and JAX's fast blocks but for
    borders that the cost's log2 moves at near-ties (the fast CLI's
    precedent, test_torch_segment.py::test_cli_fast_close_to_jax)."""
    from wgbs_tools_tpu.models.segment import SegmentConfig as JaxConfig
    from wgbs_tools_tpu.models.segment import segment_ranges as jax_ranges
    from wgbs_tools_tpu_torch.genome.refdir import Genome
    from wgbs_tools_tpu_torch.models.segment import (SegmentConfig,
                                                     segment_ranges)
    from wgbs_tools_tpu_torch.parallel.multihost import \
        run_segment_multiprocess

    paths, nr = seg_betas
    ranges = [(1, nr + 1)]
    kw = dict(SEG_KW, mode=mode)
    st_j, en_j = jax_ranges(paths, ranges, mini_genome.index,
                            JaxConfig(**kw))
    st, en = run_segment_multiprocess(paths, ranges, str(tmp_path / "seg"),
                                      num_processes=2, device="cpu",
                                      timeout=TIMEOUT, **kw)
    assert st.dtype == en.dtype == np.int64 and len(st) > 10
    if mode == "exact":
        assert st.tolist() == st_j.tolist() and en.tolist() == en_j.tolist()
        return
    st1, en1 = segment_ranges(paths, ranges, Genome(None).index,
                              SegmentConfig(**kw, device="cpu"))
    assert st.tolist() == st1.tolist() and en.tolist() == en1.tolist()
    want = set(st_j.tolist()) | set(en_j.tolist())
    share = len(want & (set(st.tolist()) | set(en.tolist()))) / len(want)
    print(f"fast --procs 2: {share:.4%} of JAX's {len(want)} borders")
    assert share >= 0.99


@pytest.mark.parametrize("out", ["blocks.bed", "blocks.bed.gz"])
def test_cli_segment_procs_bytes_equal_jax(tmp_path, seg_betas, out, capfd):
    """`segment --procs 2 --device cpu` writes the JAX CLI's bytes (bed, or
    .gz and .tbi); each worker reports its launch counts."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    paths, _ = seg_betas
    argv = ["segment", "--betas"] + paths + ["-c", "2000"]
    assert jax_main(argv + ["-o", str(tmp_path / f"j.{out}")]) == 0
    assert port_main(argv + ["-o", str(tmp_path / f"t.{out}"), "--procs",
                             "2", "--device", "cpu"]) == 0
    suffixes = ("", ".tbi") if out.endswith(".gz") else ("",)
    for suff in suffixes:
        want = (tmp_path / f"j.{out}{suff}").read_bytes()
        assert len(want) > 100
        assert (tmp_path / f"t.{out}{suff}").read_bytes() == want
    err = capfd.readouterr().err
    for r in (0, 1):
        assert f"[wgbs-torch worker {r}] launches {{\"maxplus_closure\"" in err


def test_segment_worker_fails_the_launch(tmp_path, seg_betas):
    """A segment worker that fails (a beta that is not there) fails the
    launch with its output; asking for CUDA without it raises before any
    worker starts."""
    from wgbs_tools_tpu_torch.parallel.multihost import \
        run_segment_multiprocess

    paths, nr = seg_betas
    with pytest.raises(RuntimeError,
                       match="multi-process segment failed: worker .* rc="):
        run_segment_multiprocess(paths + [str(tmp_path / "missing.beta")],
                                 [(1, nr + 1)], str(tmp_path / "seg"),
                                 num_processes=2, device="cpu",
                                 timeout=TIMEOUT, **SEG_KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_segment_multiprocess(paths, [(1, nr + 1)],
                                     str(tmp_path / "seg"), device="cuda")
