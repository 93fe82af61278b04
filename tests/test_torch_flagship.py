"""The port's flagship step (wgbs_tools_tpu_torch/flagship.py) against
__graft_entry__.py's: entry()'s forward on the same synthetic inputs, and
the multi-device dry run on CPU stand-in devices."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.parallel import sharded as J  # noqa: E402
from wgbs_tools_tpu_torch import flagship  # noqa: E402
from wgbs_tools_tpu_torch.ops.dp_scan import dp_scan_plain  # noqa: E402
from wgbs_tools_tpu_torch.parallel import sharded as P  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="the JAX package's native library "
                                       "(the reference) is unavailable")


def test_synth_inputs_equal_jax():
    for a, b in zip(flagship._synth_inputs(512, 300, 3, max_len=12, seed=4),
                    graft._synth_inputs(512, 300, 3, max_len=12, seed=4)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_equals_jax():
    """merged and the total coverage equal JAX's exactly; the DP on JAX's
    own cost gives JAX's tb bit for bit; the forward's tb equals JAX's,
    its cost agreeing with JAX's to rtol 1e-6 (the f32 log2's ulps). A
    border that those ulps move at a near-tie would show here, named by
    its site."""
    fn, args = flagship.entry(device="cpu")
    merged, tb, total = fn(*args)
    jfn, jargs = graft.entry()
    jmerged, jtb, jtotal = jax.jit(jfn)(*jargs)
    assert merged.dtype == tb.dtype == torch.int32
    assert merged.shape == (flagship.N_SITES, 2)
    assert np.array_equal(merged.numpy(), np.asarray(jmerged))
    assert int(total) == int(np.asarray(jtotal)) > 0

    # the cost both forwards build, and the DP on JAX's
    start, length, count, codes, sample_counts, loci = (np.array(a)
                                                        for a in jargs)
    counts = np.asarray(J._local_pileup(
        jnp.asarray(start - 1), jnp.asarray(length), jnp.asarray(count),
        jnp.asarray(codes), flagship.N_SITES))
    W = flagship.W
    jcost = np.zeros((flagship.N_SITES, W), np.float32)
    pcost = torch.zeros((flagship.N_SITES, W))
    for d in range(sample_counts.shape[0]):
        c = sample_counts[d] + counts
        jcost += np.asarray(J._segment_cost_local(
            jnp.asarray(c), jnp.asarray(loci), W, flagship.MAX_BP,
            flagship.PC))
        P._segment_cost_local(torch.from_numpy(c), torch.from_numpy(loci),
                              W, flagship.MAX_BP, flagship.PC, out=pcost)
    fin = np.isfinite(jcost)
    assert np.array_equal(np.isneginf(pcost.numpy()), np.isneginf(jcost))
    np.testing.assert_allclose(pcost.numpy()[fin], jcost[fin], rtol=1e-6)
    assert np.array_equal(dp_scan_plain(torch.from_numpy(jcost)[None],
                                        W)[0].numpy(), np.asarray(jtb))
    bad = np.flatnonzero(tb.numpy() != np.asarray(jtb))
    assert bad.size == 0, (f"tb differs from JAX's at sites {bad[:10]} "
                           "(a near-tie the cost's ulps move)")


def test_dryrun_multichip_4(capsys):
    """The dry run on 4 CPU stand-in devices (a (2, 2) mesh) runs JAX's
    checks and prints JAX's line; it starts 2 worker processes once."""
    flagship.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "[dryrun_multichip] ok: mesh={'samples': 2, 'sites': 2} " \
        "counts=(1024, 2) total_cov=" in out
    assert "seg_windows=5 " in out and "multiproc_beta_ok frags=7495" in out
    assert "reduce_blocks=2047 reduce_cov=" in out and "not ported" not in out
