"""`correct` comes out false where it should: for the control, the plain
reference in the precision below the cell's in the program's place, and
for each fault a cell can have, planted under a whole run on the CPU
(the look for a card skipped). The run itself, unbroken, is correct."""

import numpy as np
import pytest

from port_bench import run
from port_bench.conftest import small_cell

SEED = 2**31 + 901
SIZES = {"pat2beta.pe150": dict(n_sites=30_000, frags=30_000),
         "pat2beta.ont_long": dict(n_sites=30_000, frags=1_500),
         "segment.exact": dict(n_sites=120_000, chunk=60_000),
         "segment.fast": dict(n_sites=12_000, chunk=3_000)}


def _run(name, control=False):
    return run.run_cell(small_cell(name, **SIZES[name]), SEED, 0.01,
                        device="cpu", control=control)


@pytest.mark.parametrize("name", list(SIZES))
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", list(SIZES))
def test_control_is_not_correct(name):
    r = _run(name, control=True)
    assert not r["correct"], r["checks"]


def _halve(frags):
    """Every other line, each with twice its count: the mean over the
    rest in place of the whole."""
    keep = frags.take(np.arange(0, frags.nr_frags, 2))
    keep.count = keep.count * 2
    return keep


PAT_FAULTS = {
    "state_unchanged": lambda acc, frags, add: None,
    "half_the_batch": lambda acc, frags, add: add(acc, _halve(frags)),
}


@pytest.mark.parametrize("fault", list(PAT_FAULTS) + ["answer_altered"])
def test_pat2beta_fault(monkeypatch, fault):
    from wgbs_tools_tpu_torch.ops import pileup

    if fault == "answer_altered":
        call = pileup.call_staged

        def altered(staged, window_len, *a, **k):
            res = call(staged, window_len, *a, **k)
            res[0, 1] += 1
            return res

        monkeypatch.setattr(pileup, "call_staged", altered)
    else:
        add = pileup.PileupAccumulator.add
        monkeypatch.setattr(pileup.PileupAccumulator, "add",
                            lambda acc, frags: PAT_FAULTS[fault](acc, frags,
                                                                 add))
    r = _run("pat2beta.pe150")
    assert not r["correct"], r["checks"]
    assert r["checks"]["beta_sites_wrong"]["value"] > 0


def test_segment_fault_state_unchanged(monkeypatch):
    """The DP hands back its start: one block a window."""
    from wgbs_tools_tpu_torch.models import segment

    monkeypatch.setattr(segment, "_traceback",
                        lambda T, n: np.array([0, n], np.int64))
    r = _run("segment.exact")
    assert not r["correct"], r["checks"]


def test_segment_fault_half_the_batch(monkeypatch):
    """Half of each window's sites left out, the other half's counts
    doubled."""
    from wgbs_tools_tpu_torch.models import segment

    load = segment.load_beta

    def half(path, sites=None):
        d = load(path, sites=sites).copy()
        d[1::2] = 0
        d[0::2] = np.minimum(2 * d[0::2].astype(np.int64), 255)
        return d

    monkeypatch.setattr(segment, "load_beta", half)
    r = _run("segment.exact")
    assert not r["correct"], r["checks"]
    assert r["checks"]["border_diff_share"]["value"] > \
        r["checks"]["border_diff_share"]["limit"]


def test_segment_fault_answer_altered(monkeypatch):
    """One block's locus changed where the bed's columns are made."""
    from wgbs_tools_tpu_torch.cli import cmd_segment

    blocks_of = cmd_segment.sites_blocks

    def altered(index, sites):
        b = blocks_of(index, sites)
        b["start"][len(b["start"]) // 2] += 1
        return b

    monkeypatch.setattr(cmd_segment, "sites_blocks", altered)
    r = _run("segment.exact")
    assert not r["correct"], r["checks"]
    assert r["checks"]["bed_locus_errors"]["value"] == 1
