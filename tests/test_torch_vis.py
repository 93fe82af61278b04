"""The port's figure and terminal commands (cli/cmd_vis.py: vis, pat_fig;
cli/cmd_misc.py: mbias_plot; bam2pat --mbias's plot; beta_cov --plot and
compare_betas' figure) against the JAX CLI on the same inputs.

vis prints the same text, byte for byte, for pats and betas in --text,
--no_color and colour modes. Each figure is written by the JAX CLI and by
the port's CLI in this process, under matplotlib's Agg backend, each
starting with no figure open (beta_cov --plot draws on pyplot's current
figure), with SOURCE_DATE_EPOCH set so a PDF carries no clock time; the
two files are equal in bytes. The figure tests skip where matplotlib is
absent. The pats and betas come from the JAX CLI's bam2pat of simulated
BAMs over the mini genome of tests/conftest.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bisim import dump_bam, simulate_reads  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.genome.cpg_index import read_fasta  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")


def _matplotlib():
    return pytest.importorskip("matplotlib", reason="matplotlib is absent: "
                               "the figure commands need it")


@pytest.fixture(scope="module")
def data(mini_genome, tmp_path_factory):
    from wgbs_tools_tpu.cli.main import main as jax_main

    d = tmp_path_factory.mktemp("vis")
    rng = np.random.default_rng(2109)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    out = {}
    for name, paired, n in (("pe", True, 3000), ("se", False, 2000)):
        reads, _ = simulate_reads(seqs, rng, n_reads=n, paired=paired)
        bam = dump_bam(reads, seqs, str(d / f"{name}.bam"))
        out[name + "_bam"] = bam
        assert jax_main(["bam2pat", bam, "-o", str(d)]) == 0
        out[name] = str(d / f"{name}.pat.gz")
        out[name + "_beta"] = str(d / f"{name}.beta")
    mb = d / "mb"
    mb.mkdir()
    assert jax_main(["bam2pat", out["pe_bam"], "-o", str(mb), "--mbias",
                     "--no_beta"]) == 0
    out["ot"] = str(mb / "pe.mbias.OT.txt")
    out["ob"] = str(mb / "pe.mbias.OB.txt")
    bed = d / "blocks.bed"
    bed.write_text("chr1\t0\t1\t100\t120\nchr1\t0\t1\t120\t131\n"
                   "chr1\t0\t1\t131\t160\n")
    out["bed"] = str(bed)
    names = d / "names.csv"
    names.write_text("pe,paired reads\nse,single\n")
    out["names"] = str(names)
    return out


def _both(cmd, argv, data, tmp_path, capsys, monkeypatch, device=False,
          rc=0):
    """The JAX CLI and the port's CLI (with --device cpu when `device`),
    each writing into its own directory ("OUT", "OUT/<name>") with no
    figure open; returns the directories and the text each printed."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    names = {"PE": data["pe"], "SE": data["se"], "A": data["pe_beta"],
             "B": data["se_beta"], "BED": data["bed"], "OT": data["ot"],
             "OB": data["ob"], "NAMES": data["names"],
             "PE_BAM": data["pe_bam"]}
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    dirs, texts = [], []
    capsys.readouterr()
    for who, main in (("j", jax_main), ("t", port_main)):
        d = tmp_path / who
        d.mkdir()
        args = [str(d) if a == "OUT" else str(d / a[4:])
                if a.startswith("OUT/") else names.get(a, a) for a in argv]
        if device and who == "t":
            args += ["--device", "cpu"]
        try:
            import matplotlib.pyplot as plt

            plt.close("all")
        except ImportError:
            pass
        assert main([cmd] + args) == rc
        dirs.append(d)
        texts.append(capsys.readouterr().out)
    return dirs, texts


def assert_same_dirs(j, t, min_files=1):
    want = {p.name: p.read_bytes() for p in j.iterdir() if p.is_file()}
    got = {p.name: p.read_bytes() for p in t.iterdir() if p.is_file()}
    assert sorted(got) == sorted(want)
    assert len(want) >= min_files
    for name in want:
        assert got[name] == want[name], name


VIS_CASES = {
    "pat_text": ["PE", "-s", "100-160", "--text"],
    "pat_no_color": ["PE", "-r", "chr1:2000-6000", "--no_color"],
    "pat_color": ["PE", "SE", "-s", "100-160"],
    "pat_strike_yebl": ["SE", "-s", "100-160", "--strike", "--yebl"],
    "pat_uxm_hmc": ["PE", "-s", "90-150", "--uxm", "0.6", "--hmc", "--text",
                    "--no_color"],
    "pat_blocks_reps": ["PE", "-s", "100-160", "-b", "BED", "--max_reps",
                        "2", "--no_dense", "--text"],
    "pat_filters": ["PE", "-s", "100-200", "--min_len", "3", "--strict",
                    "--strip", "--no_gaps", "--title", "a title"],
    "pat_shuffle": ["SE", "-s", "100-160", "--shuffle", "--seed", "3",
                    "--text", "--no_color"],
    "pat_sub_sample": ["PE", "-s", "100-400", "--sub_sample", "0.3",
                       "--seed", "5", "--text"],
    "beta_color": ["A", "B", "-s", "100-260"],
    "beta_no_color_bar": ["A", "B", "-s", "100-260", "--no_color",
                          "--colorbar"],
    "beta_heatmap_256": ["A", "-r", "chr2:1000-9000", "--heatmap", "-cs",
                         "256", "--colorbar", "-c", "3"],
    "beta_blocks": ["A", "B", "-s", "100-160", "-b", "BED", "--heatmap"],
}


@pytest.mark.parametrize("case", sorted(VIS_CASES))
def test_vis_equals_jax_cli(data, tmp_path, capsys, monkeypatch, case):
    _, (jt, tt) = _both("vis", VIS_CASES[case], data, tmp_path, capsys,
                        monkeypatch)
    assert tt == jt and tt.count("\n") >= 3


def test_vis_refuses_what_jax_refuses(data, tmp_path, capsys, monkeypatch):
    _both("vis", ["PE"], data, tmp_path, capsys, monkeypatch, rc=1)


FIG_CASES = {
    "pat_fig": ("pat_fig", ["PE", "SE", "-s", "100-160", "-o",
                            "OUT/f.png"], False),
    "pat_fig_names_bw": ("pat_fig", ["PE", "SE", "-s", "100-140",
                                     "--name_table", "NAMES",
                                     "--black_white", "--col_wrap", "1",
                                     "--top", "30", "-o", "OUT/f.png"],
                         False),
    "vis_plot": ("vis", ["A", "B", "-s", "100-180", "-b", "BED", "--plot",
                         "--output", "OUT/v.png", "--title", "t"], False),
    "beta_cov_plot": ("beta_cov", ["A", "B", "--plot", "-o", "OUT/c.png"],
                      True),
    "compare_betas": ("compare_betas", ["A", "B", "-c", "1", "--bins", "11",
                                        "-o", "OUT/cmp.png"], False),
    "compare_betas_pdf": ("compare_betas", ["A", "B", "-o", "OUT/cmp.pdf"],
                          False),
    "mbias_plot": ("mbias_plot", ["OT", "OB", "-o", "OUT"], False),
    "mbias_plot_pe": ("mbias_plot", ["OB", "OT", "-o", "OUT", "-PE"], False),
    "bam2pat_mbias": ("bam2pat", ["PE_BAM", "-o", "OUT", "--mbias"], True),
}


@pytest.mark.parametrize("case", sorted(FIG_CASES))
def test_figure_equals_jax_cli(data, tmp_path, capsys, monkeypatch, case):
    _matplotlib()
    cmd, argv, device = FIG_CASES[case]
    (j, t), (jt, tt) = _both(cmd, argv, data, tmp_path, capsys, monkeypatch,
                             device=device)
    assert tt.replace(str(t), "OUT") == jt.replace(str(j), "OUT")
    figs = [p for p in t.iterdir() if p.suffix in (".png", ".pdf")]
    assert len(figs) == 1 and figs[0].stat().st_size > 1000
    assert_same_dirs(j, t)

