"""Multi-process pat2beta of the port (parallel/multihost.py): N worker
processes join one torch.distributed (gloo) job over 127.0.0.1, each piles
up its own site range and writes its byte range; the beta equals the JAX
package's single-process bytes."""

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
                                       "--out", "y", "--nr_sites", "5"]])
def test_worker_bad_args_exit_2(args):
    r = subprocess.run(WORKER + args, capture_output=True, timeout=TIMEOUT,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 2  # argparse usage error, before any init
