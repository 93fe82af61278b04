"""The port's pat2beta writes the same .beta / .lbeta bytes as the JAX
package's, through the Python entry point and the CLI."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.formats.pat import write_pat  # noqa: E402
from wgbs_tools_tpu.pipeline.pat2beta import (  # noqa: E402
    pat2beta as jax_pat2beta,
    pat2beta_counts as jax_pat2beta_counts,
)
from wgbs_tools_tpu_torch.pipeline.pat2beta import (  # noqa: E402
    pat2beta,
    pat2beta_counts,
)

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

N_SITES = 9000


class _Genome:
    nr_sites = N_SITES

    def get_nr_sites(self):
        return N_SITES


@pytest.fixture(scope="module")
def pats(tmp_path_factory):
    """A plain pat (every count < 256: the value-plane kernel) and one with
    counts up to 3000 (the classic kernel)."""
    d = tmp_path_factory.mktemp("pats")
    rng = np.random.default_rng(31)
    plain = random_frags(rng, 6000, N_SITES - 30, max_len=24, h_rate=0.03)
    deep = random_frags(rng, 1500, N_SITES - 200, max_len=150,
                        max_count=3000, dot_rate=0.1)
    assert int(deep.count.max()) >= 256
    out = {}
    for name, f in (("plain", plain), ("deep", deep)):
        out[name] = str(d / f"{name}.pat.gz")
        write_pat(f, out[name])
    return out


@pytest.mark.parametrize("pat", ["plain", "deep"])
@pytest.mark.parametrize("lbeta", [False, True])
@pytest.mark.parametrize("backend,chunk_bytes", [("cuda", 32 << 20),
                                                 ("cuda", 20_000),
                                                 ("torch", 50_000)])
def test_pat2beta_bytes_equal_jax(tmp_path, pats, pat, lbeta, backend,
                                  chunk_bytes):
    want = jax_pat2beta(pats[pat], genome=_Genome(), lbeta=lbeta,
                        sharded=False, out_path=str(tmp_path / "j"))
    got = pat2beta(pats[pat], genome=_Genome(), lbeta=lbeta,
                   backend=backend, chunk_bytes=chunk_bytes,
                   out_path=str(tmp_path / "t"), device="cpu")
    data = open(got, "rb").read()
    assert len(data) == N_SITES * 2 * (2 if lbeta else 1)
    assert data == open(want, "rb").read()


def test_pat2beta_counts_equal_jax(pats):
    want = jax_pat2beta_counts(pats["deep"], N_SITES, sharded=False)
    got = pat2beta_counts(pats["deep"], N_SITES, device="cpu")
    assert got.dtype == np.int64 and np.array_equal(got, want)


# the port's keywords for the JAX package's WGBS_TPU_V3_VALS=0,
# WGBS_TPU_PILEUP_V3_GRID=tiled and backends "pallas2" and "pallas"
CONFIGS = {"vals_false": dict(vals=False), "grid_tiled": dict(grid="tiled"),
           "cuda_v2": dict(backend="cuda_v2"),
           "cuda_v1": dict(backend="cuda_v1")}


@pytest.mark.parametrize("pat", ["plain", "deep"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pat2beta_configs_bytes_equal_jax(tmp_path, pats, pat, config):
    """pat2beta through each of the four configurations (small slabs, so
    several batches fold into the total) writes the JAX package's bytes."""
    want = jax_pat2beta(pats[pat], genome=_Genome(), sharded=False,
                        out_path=str(tmp_path / "j"))
    got = pat2beta(pats[pat], genome=_Genome(), chunk_bytes=40_000,
                   out_path=str(tmp_path / "t"), device="cpu",
                   **CONFIGS[config])
    assert open(got, "rb").read() == open(want, "rb").read()


def test_pat2beta_sharded_takes_no_forms(tmp_path, pats):
    from wgbs_tools_tpu_torch.parallel.mesh import shard_devices

    with pytest.raises(ValueError, match="form keywords"):
        pat2beta(pats["plain"], genome=_Genome(), vals=False,
                 out_path=str(tmp_path / "x"),
                 devices=shard_devices("cpu", n_shards=2))
    with pytest.raises(ValueError, match="backend"):
        pat2beta(pats["plain"], genome=_Genome(), backend="cuda_v2",
                 out_path=str(tmp_path / "x"),
                 devices=shard_devices("cpu", n_shards=2))


def test_pat2beta_timings(tmp_path, pats):
    timings = {}
    pat2beta(pats["plain"], genome=_Genome(), chunk_bytes=50_000,
             out_path=str(tmp_path / "x.beta"), device="cpu",
             timings=timings)
    assert set(timings) == {"decode", "stage", "h2d", "kernel",
                            "saturate_fetch", "write"}


def test_cli_pat2beta_equals_jax_cli(tmp_path, mini_genome, monkeypatch):
    """`python -m wgbs_tools_tpu_torch pat2beta --device cpu` writes the
    JAX CLI's bytes; without --device it asks for CUDA and raises when
    there is none."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    n = mini_genome.get_nr_sites()
    f = random_frags(np.random.default_rng(41), 3000, n - 20, max_len=16,
                     max_count=400)
    pat = str(tmp_path / "s.pat.gz")
    write_pat(f, pat)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert jax_main(["pat2beta", pat, "-o", str(tmp_path / "j")]) == 0
    assert port_main(["pat2beta", pat, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    want = (tmp_path / "j" / "s.beta").read_bytes()
    assert len(want) == 2 * n
    assert (tmp_path / "t" / "s.beta").read_bytes() == want

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["pat2beta", pat, "-o", str(tmp_path / "t"), "-f"])
    assert port_main(["pat2bta"]) == 1
