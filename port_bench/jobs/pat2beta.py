"""Jobs of `pat2beta`: a pat.gz of the traffic's lines to a beta of every
site of the genome, through the port's entry
pipeline/pat2beta.py::pat2beta on the run's device.

Set-up draws the genome, one sample's methylation and the lines from the
seed (port_bench/gen.py), writes the CpG index, the pat.gz and a warm-up
pat of its first `warmup_lines` lines under the run's directory. Each job
writes its own beta; the check holds every one of them to the
configuration's reference, byte for byte.
"""

import os.path as op

import numpy as np

from port_bench import gen, work

# (module[:class], attribute, span): the layers the traced run labels
SPANS = [
    ("wgbs_tools_tpu_torch.ops.pileup", "stage_v3", "pat2beta.stage"),
    ("wgbs_tools_tpu_torch.ops.pileup", "staged_from_numpy", "pat2beta.h2d"),
    ("wgbs_tools_tpu_torch.ops.pileup", "call_staged", "pat2beta.kernel"),
    ("wgbs_tools_tpu_torch.ops.pileup:PileupAccumulator", "add",
     "pat2beta.add"),
    ("wgbs_tools_tpu_torch.ops.pileup:PileupAccumulator", "finalize",
     "pat2beta.finalize"),
]
# the pileup kernels, by the names the device trace gives them
PILEUP_KERNELS = (r"flat_vals_fused_kernel|flat_vals_kernel|flat_vals_add_"
                  r"kernel|flat_classic_kernel|flat_lc_kernel|tiled_classic_"
                  r"kernel|tiles_v2_kernel|tiles_v1_kernel")


class State:
    pass


def setup(cell, seed, dev, work_dir):
    cfg, traffic = cell.config, cell.traffic
    st = State()
    st.cell, st.dev, st.work = cell, dev, work_dir
    genome = gen.make_genome(cfg["genome"], seed, dev)
    level = gen.block_levels(genome, cfg["methylation"], seed, dev)[0]
    st.frags = gen.make_frags(genome, level, {**traffic,
                                              "depth": cfg["depth"]},
                              seed, dev)
    st.n_sites = genome.n_sites
    gen.write_cpg_index(op.join(work_dir, "refs"), cfg["genome"]["name"],
                        genome)
    st.pat = gen.write_pat_gz(op.join(work_dir, "sample.pat.gz"), st.frags,
                              genome.names, dev)
    warm = gen.Frags(*(getattr(st.frags, k) for k in
                       ("start", "length", "count", "chrom", "codes")))
    nw = min(st.frags.n, int(traffic["warmup_lines"]))
    off = st.frags.offsets()
    warm.start, warm.length = warm.start[:nw], warm.length[:nw]
    warm.count, warm.chrom = warm.count[:nw], warm.chrom[:nw]
    warm.codes = warm.codes[: off[nw]]
    st.warm_pat = gen.write_pat_gz(op.join(work_dir, "warm.pat.gz"), warm,
                                   genome.names, dev)
    del genome, level

    from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta

    st.entry = pat2beta
    st.outputs = []
    return st


def warmup(st):
    st.entry(st.warm_pat, out_path=op.join(st.work, "warm.beta"),
             device=str(st.dev))


def run(st, i, timings):
    out = op.join(st.work, f"job{i}.beta")
    st.entry(st.pat, out_path=out, device=str(st.dev), timings=timings)
    st.outputs.append(out)
    return {"pat2beta_frags_per_s": st.frags.n}



def work_counts(st):
    """Per-job (bytes, ops) of the pileup, from the lines."""
    return work.pileup_work(st.frags)


def check(st, n_jobs, control=False):
    """Every job's beta against the reference's bytes: the number compared
    is the most sites that differ in one job's file (or every site, where
    the file's size is wrong). With `control`, the reference computed in
    four bits stands in the program's place."""
    ref = st.cell.reference
    want = ref.beta(st.frags, st.n_sites)
    outs = list(st.outputs)
    if control:
        path = op.join(st.work, "control.beta")
        ref.beta(st.frags, st.n_sites, bits=4).tofile(path)
        outs = [path]
    limit = st.cell.traffic["limits"]["beta_sites_wrong"]
    worst, bad = 0, 0
    for path in outs:
        got = np.fromfile(path, np.uint8)
        if got.size != want.size:
            wrong = st.n_sites
        else:
            wrong = int((got.reshape(-1, 2) != want).any(axis=1).sum())
        worst = max(worst, wrong)
        bad += wrong > limit
    return {"beta_sites_wrong": {"value": worst, "limit": limit}}, bad
