"""Shared helpers of the benchmark's own tests: cells cut to a size the CPU
runs in seconds. Run them with `python -m pytest port_bench -q` from the
root of the repo; the tests marked `cuda` skip without a card."""

import pytest

from port_bench import run

SMALL_CHROMS = [["chr1", 2_200_000], ["chr2", 1_100_000], ["chr21", 300_000]]


def small_cell(name, n_sites=30_000, frags=40_000, chunk=5_000):
    """The BENCHMARK.json cell `name` with a genome of n_sites sites over
    three small chromosomes (~110 bp apart), the traffic's line count cut
    to `frags` and segment's chunks to `chunk` sites."""
    cell = run.Cell(name)
    g = cell.config["genome"]
    g["n_sites"] = n_sites
    g["chroms"] = SMALL_CHROMS
    scale = n_sites * 110 / sum(c[1] for c in SMALL_CHROMS)
    g["chroms"] = [[n, int(s * scale)] for n, s in SMALL_CHROMS]
    if "frags" in cell.traffic:
        cell.traffic["frags"] = frags
        cell.traffic["warmup_lines"] = max(1, frags // 10)
    if "chunk_size" in cell.config:
        cell.config["chunk_size"] = chunk
        cell.traffic["warmup_region"] = "chr21"
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
