"""vis: terminal visualization of pat and beta files
(ref: src/python/vis.py, pat_vis.py, beta_vis.py, pat_fig.py).

The port's copy of wgbs_tools_tpu/cli/cmd_vis.py: `vis` (text and colour
renderings of pats and betas, and the beta heatmap of --plot) and
`pat_fig`. Host code; matplotlib is imported only when a figure is asked
for.
"""

import argparse
import re
import sys

import numpy as np

from ..formats.beta import load_beta
from ..formats.blocks import load_blocks
from ..genome.refdir import Genome
from ..genome.region import GenomicRegion
from ..utils import IllegalArgumentError, pretty_name, validate_file_list
from .main import add_gr_args, add_view_args
from .view import _shuffle_within_start, view_pat

FULL_CIRCLE = "●"
FULL_SQUARE = "■"
DASH = "—"
BORDER = "|"

NUM2COLOR = {
    "C": "01;31", "T": "01;32", "X": "01;33", "M": "01;31", "U": "01;32",
    "H": "01;33", "c": "01;106", "t": "01;90", "g": "01;91", "a": "01;92",
}
NUM2COLOR_YEBL = {"T": "01;34", "C": "01;33", "X": "01;33", "M": "01;31",
                  "U": "01;32"}


def color_text(txt, cdict, scheme=16):
    """ANSI coloring (ref: utils_wgbs.py:192-200)."""
    if scheme == 16:
        return "".join(
            f"\033[{cdict[c]}m{c}\033[00m" if c in cdict else c for c in txt
        )
    return "".join(
        f"[38;5;{cdict[c]}m{c}[0m" if c in cdict else c
        for c in txt
    )


# ---------------------------------------------------------------- pat vis


def pack_reads_to_table(frags, window_start, window_end, max_reps=10,
                        no_dense=False, uxm=None):
    """Greedy packing of reads into a 2-D character table
    (ref: pat_vis.py:162-230). Returns (table chars, first_site, uxm_counts,
    score tuple)."""
    if frags.nr_frags == 0:
        return None
    longest = int(frags.length.max())
    first = int(frags.start.min())
    max_width = window_end - window_start + 2 * longest
    n_rows = int(frags.count.sum()) + 1
    table = np.zeros((n_rows, max_width), dtype=np.int16)
    # codes: 0=empty, 1=space, then ord of char
    SPACE = 1

    from ..formats.pat import _DECODE_LUT

    uxm_counts = {"U": 0, "X": 0, "M": 0}
    nm = nh = nu = 0
    for i in range(frags.nr_frags):
        patt = _DECODE_LUT[frags.codes[i, : frags.length[i]]].tobytes().decode()
        count = int(frags.count[i])
        nm += patt.count("C") * count
        nh += patt.count("H") * count
        nu += patt.count("T") * count
        if not patt.strip("."):
            continue
        if uxm:
            u_sites = patt.count("T")
            m_sites = patt.count("C")
            total = u_sites + m_sites
            if total == 0:
                continue
            if u_sites / total >= uxm:
                status = "U"
            elif m_sites / total >= uxm:
                status = "M"
            else:
                status = "X"
            uxm_counts[status] += count
            patt = status * len(patt)
        vals = np.array([ord(c) for c in patt], dtype=np.int16)
        for _ in range(min(max_reps, count)):
            col = int(frags.start[i]) - first
            if col < 0:
                raise IllegalArgumentError("Error: Pat is not sorted!")
            if no_dense:
                row = int(np.argmin(table.sum(axis=1)))
            else:
                row = int(np.argmin(table[:, col]))
            table[row, col : col + len(patt)] = vals
            table[row, :col][table[row, :col] == 0] = SPACE
            table[row, col + len(patt)] = SPACE

    nr_lines = int(np.argmin(table[:, 0]))
    width = int(np.max(np.argmin(table, axis=1))) if table.size else 0
    table = table[:nr_lines, :width]
    table[table == 0] = SPACE
    if first > window_start:
        table = np.concatenate(
            [np.full((table.shape[0], first - window_start), SPACE,
                     dtype=np.int16), table],
            axis=1,
        )
        first = window_start
    chars = np.where(table == SPACE, ord(" "), table).astype(np.uint8)
    ntotal = nm + nu + nh
    score = (
        (int(100 * (nm + nh) / ntotal), int(100 * nh / ntotal))
        if ntotal else "NA"
    )
    return chars, first, uxm_counts, score


def render_pat(frags, gr, blocks=None, no_color=False, text=False,
               strike=False, yebl=False, max_reps=10, no_dense=False,
               uxm=None, hmc=False, out=None):
    out = out or sys.stdout
    packed = pack_reads_to_table(frags, gr.sites[0], gr.sites[1],
                                 max_reps=max_reps, no_dense=no_dense,
                                 uxm=uxm)
    if packed is None:
        out.write("(no reads)\n")
        return
    chars, first, uxm_counts, score = packed
    if score != "NA":
        line = f"Methylation average: {score[0]}%"
        if hmc:
            line += f" | Hydroxymethylation average: {score[1]}%"
        if uxm:
            arr = np.array([uxm_counts[k] for k in "UXM"])
            tot = max(arr.sum(), 1)
            line += "\nUXM [{}/{}/{}]".format(*arr)
            line += " [{:.1%}/{:.1%}/{:.1%}]".format(*(arr / tot))
        out.write(line + "\n")

    markers = " " * (gr.sites[0] - first) + "+" * (gr.sites[1] - gr.sites[0])
    rows = ["".join(chr(c) for c in row) for row in chars]

    if blocks is not None:
        borders = _borders_in_window(blocks, first, first + chars.shape[1])
        if borders.size:
            rows = [_insert_borders(r, borders) for r in rows]
            markers = _insert_borders(markers.ljust(chars.shape[1]), borders)

    txt = "\n".join(rows)
    if not no_color:
        txt = color_text(txt, NUM2COLOR_YEBL if yebl else NUM2COLOR)
    if not text:
        txt = re.sub("[CTUXMH]", FULL_CIRCLE, txt)
        txt = re.sub(r"\.", DASH, txt)
        if strike:
            txt = txt.replace(FULL_CIRCLE, FULL_CIRCLE + "̶")
    out.write(markers + "\n")
    out.write(txt + "\n")


def _borders_in_window(blocks, start, end):
    vals = np.sort(np.unique(np.concatenate(
        [blocks["startCpG"], blocks["endCpG"]]))) - start
    return vals[(vals >= 0) & (vals <= end - start)]


def _insert_borders(row, borders):
    arr = list(row)
    for b in sorted(borders.tolist(), reverse=True):
        if b <= len(arr):
            arr.insert(b, BORDER)
    return "".join(arr)


# ---------------------------------------------------------------- beta vis


def beta_color_dict(scheme=16):
    if scheme == 16:
        colors = ["01;92", "92", "32", "32", "34", "34", "02;31", "02;31",
                  "31", "01;31"]
    else:
        colors = [10, 47, 70, 28, 3, 3, 202, 204, 197, 196]
    return {str(i): colors[i] for i in range(10)}


def render_beta(paths, gr, min_cov=1, no_color=False, heatmap=False,
                blocks=None, color_scheme=16, out=None, colorbar=False):
    out = out or sys.stdout
    cdict = beta_color_dict(color_scheme)
    s, e = gr.sites
    borders = (
        _borders_in_window(blocks, s, e) if blocks is not None else
        np.array([])
    )
    fname_len = min(50, max(len(pretty_name(f)) for f in paths)) + 1
    for fpath in paths:
        data = load_beta(fpath, sites=(s, e)).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            vec = np.round(data[:, 0] / data[:, 1] * 10, 0)
        vec = np.nan_to_num(vec, nan=-1).astype(int)
        vec[vec == 10] = 9
        vec[data[:, 1] < min_cov] = -1
        vals = ["." if x == -1 else str(x) for x in vec]
        if borders.size:
            vals = list(np.insert(np.array(vals, dtype=object), borders, "|"))
        line = "".join(vals)
        if not no_color:
            line = color_text(line, cdict, scheme=color_scheme)
            if heatmap:
                line = re.sub("m[0-9]", "m" + FULL_SQUARE, line)
                line = re.sub(r"\.", " ", line)
        out.write(pretty_name(fpath)[:fname_len].ljust(fname_len) + ": "
                  + line + "\n")
    if colorbar:
        digits = "0123456789"
        out.write("colorbar\n")
        bar = digits if no_color else color_text(digits, cdict,
                                                 scheme=color_scheme)
        if not no_color and heatmap:
            bar = re.sub("m[0-9]", "m" + FULL_SQUARE, bar)
        out.write(bar + "\n")
        if heatmap:
            out.write(digits + "\n")


# ---------------------------------------------------------------- CLI


def main(argv):
    p = argparse.ArgumentParser(prog="vis",
                                description="Visualize pat/beta in terminal")
    p.add_argument("input_files", nargs="+")
    add_gr_args(p, bed_file=True, no_anno=True)
    add_view_args(p)
    p.add_argument("--max_reps", "-m", type=int, default=10)
    p.add_argument("--no_dense", action="store_true")
    p.add_argument("--no_color", action="store_true")
    p.add_argument("--text", action="store_true")
    p.add_argument("--strike", action="store_true")
    p.add_argument("--yebl", action="store_true")
    p.add_argument("--uxm", type=float, default=None)
    p.add_argument("--hmc", action="store_true")
    p.add_argument("-c", "--min_cov", type=int, default=1)
    p.add_argument("--heatmap", action="store_true")
    p.add_argument("--color_scheme", "-cs", type=int, default=16,
                   choices=[16, 256])
    p.add_argument("-b", "--blocks_path", default=None)
    p.add_argument("-t", "--title", default=None,
                   help="text printed before the results")
    p.add_argument("--colorbar", action="store_true",
                   help="beta vis: print the 0-9 color scale")
    p.add_argument("--plot", action="store_true",
                   help="beta vis: render a matplotlib heatmap")
    p.add_argument("--output", default=None,
                   help="beta vis: save the --plot figure to a file")
    args = p.parse_args(argv)
    validate_file_list(args.input_files)
    g = Genome(args.genome)
    gr = GenomicRegion(region=args.region, sites=args.sites, genome=g,
                       no_anno=args.no_anno)
    if gr.is_whole():
        raise IllegalArgumentError("vis requires a region (-r or -s)")
    if args.title:
        print(args.title)
    print(gr)
    blocks = load_blocks(args.blocks_path) if args.blocks_path else None

    if args.input_files[0].endswith((".beta", ".lbeta")):
        render_beta(args.input_files, gr, min_cov=args.min_cov,
                    no_color=args.no_color, heatmap=args.heatmap,
                    blocks=blocks, color_scheme=args.color_scheme,
                    colorbar=args.colorbar)
        if args.plot:
            plot_beta(args.input_files, gr, blocks=blocks,
                      title=args.title, output=args.output)
        return 0
    for pat in args.input_files:
        print(pretty_name(pat))
        frags = view_pat(pat, g, sites=f"{gr.sites[0]}-{gr.sites[1]}",
                         strict=args.strict, strip=args.strip,
                         min_len=args.min_len, no_gaps=args.no_gaps,
                         sub_sample=args.sub_sample, seed=args.seed)
        if args.shuffle:
            frags = _shuffle_within_start(frags, args.seed)
        render_pat(frags, gr, blocks=blocks, no_color=args.no_color,
                   text=args.text, strike=args.strike, yebl=args.yebl,
                   max_reps=args.max_reps, no_dense=args.no_dense,
                   uxm=args.uxm, hmc=args.hmc)
    return 0


def plot_beta(beta_paths, gr, blocks=None, title=None, output=None):
    """Matplotlib heatmap of per-site methylation means
    (ref: beta_vis.py:90-110)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..formats.beta import beta2vec, load_beta

    s, e = gr.sites
    rows = []
    for fpath in beta_paths:
        data = load_beta(fpath, sites=(s, e))
        rows.append(beta2vec(data).reshape(1, -1))
    r = np.concatenate(rows)
    plt.imshow(1 - r, cmap="RdYlGn")
    borders = _borders_in_window(blocks, s, e) if blocks is not None else \
        np.array([])
    if borders.size:
        plt.vlines(borders - 0.5, -0.5, len(beta_paths) - 0.5)
    plt.yticks(np.arange(len(beta_paths)),
               [pretty_name(f) for f in beta_paths])
    if title:
        plt.title(title)
    if output is not None:
        plt.savefig(output)
    plt.close()


# pat_fig int codes (ref: pat_vis.py:19 str2int order '',' ','.','C','T',...)
_FIG_CODES = {0: 0, ord(" "): 1, ord("."): 2, ord("C"): 3, ord("T"): 4,
              ord("U"): 5, ord("X"): 6, ord("M"): 7, ord("c"): 8,
              ord("t"): 9, ord("g"): 10, ord("a"): 11, ord("H"): 12}
_FIG_LUT = np.ones(256, dtype=np.int64)
for _k, _v in _FIG_CODES.items():
    _FIG_LUT[_k] = _v


def _fig_pad(table, height=None, width=None):
    """Zero-pad a table up to (height, width) (ref: pat_fig.py:137-151)."""
    height = table.shape[0] if height is None else height
    width = table.shape[1] if width is None else width
    if height < table.shape[0] or width < table.shape[1]:
        raise IllegalArgumentError(
            f"unable to pad table with shape {table.shape}")
    padz = np.zeros((height, width), dtype=np.int64)
    padz[: table.shape[0], : table.shape[1]] = table
    return padz


def _strikes_coords(kf):
    """Horizontal extents of covered runs per row (ref: pat_fig.py:57-63)."""
    kf = kf.copy()
    kf[kf < 2] = 0
    kf[kf > 1] = 1
    z = np.zeros((kf.shape[0], 1))
    dif = np.diff(np.hstack([z, kf, z]))
    return np.hstack(
        [np.argwhere(dif == 1), np.argwhere(dif == -1)]
    )[:, [0, 1, 3]].T


def _plot_fig_table(tf, headers, gr, args):
    """Circles/strikes rendering (ref: pat_fig.py:65-115)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    height, width = tf.shape
    fig = plt.figure(
        figsize=(args.fig_height * (width / height), args.fig_height),
        facecolor="none")
    ax = fig.add_subplot(111)
    ax.set_ylim((-1, height + 1 + 3))
    ax.set_xlim((-1, width + 1))

    hly, xmins, xmaxs = _strikes_coords(tf)
    bbox = ax.get_window_extent().transformed(
        fig.dpi_scale_trans.inverted())
    msize = (bbox.width / width * 43) * args.circle_size
    lw = msize / 5 * args.line_width
    ax.hlines(height - hly, xmin=xmins - .5, xmax=xmaxs - .5, lw=lw,
              color="black", zorder=-1)

    def plot_circles(simb, color):
        if not (tf == simb).any():
            return
        x, y = np.argwhere(tf == simb).T[::-1]
        ax.plot(x, height - y, "o", markersize=msize, markeredgewidth=lw,
                markeredgecolor="black", c=color)

    meth_color = "black" if args.black_white else args.meth_color
    unmeth_color = "white" if args.black_white else args.unmeth_color
    plot_circles(3, meth_color)
    plot_circles(4, unmeth_color)

    fsize = msize * 1.5 * args.font_size
    for trio in headers:
        ax.text(*trio, color="black", fontsize=fsize)
    title = args.title or str(gr).replace("\t", " ")
    plt.title(title, size=fsize * 1.2)
    plt.axis("off")
    plt.savefig(args.outpath, transparent=True)
    plt.close(fig)


def main_pat_fig(argv):
    """Publication-style matplotlib figure of pat visualization
    (ref: src/python/pat_fig.py: per-pat packed tables padded and tiled
    col_wrap per row, strikethrough runs + C/T circles)."""
    p = argparse.ArgumentParser(prog="pat_fig")
    p.add_argument("pats", nargs="+")
    add_gr_args(p, no_anno=True)
    add_view_args(p, out_path=False)
    p.add_argument("--max_name_chars", "-K", type=int, default=50,
                   help="trim file names at K characters")
    p.add_argument("-o", "--outpath", required=True)
    p.add_argument("--top", type=int, default=1000,
                   help="at most TOP reads per pat file")
    p.add_argument("--max_reps", "-m", type=int, default=10)
    p.add_argument("--no_dense", action="store_true")
    p.add_argument("--uxm", type=float, default=None)
    # accepted for reference-parser parity (ref pat_fig builds on vis's pat
    # parser, pat_fig.py:9); the figure renderer always draws circles+strikes
    p.add_argument("--text", action="store_true")
    p.add_argument("--strike", action="store_true")
    p.add_argument("--yebl", action="store_true")
    p.add_argument("--hmc", action="store_true")
    p.add_argument("--col_wrap", type=int, default=5)
    p.add_argument("--space_cols", type=int, default=1)
    p.add_argument("--space_rows", type=int, default=4)
    p.add_argument("--circle_size", type=float, default=1.0)
    p.add_argument("--line_width", type=float, default=1.0)
    p.add_argument("--font_size", type=float, default=1.0)
    p.add_argument("--title")
    p.add_argument("--fig_height", type=int, default=20)
    p.add_argument("--blocks_path")
    p.add_argument("--name_table",
                   help="csv (no header): original pat name -> new name")
    p.add_argument("--black_white", action="store_true")
    p.add_argument("--meth_color", "-M", default="yellow")
    p.add_argument("--unmeth_color", "-U", default="blue")
    args = p.parse_args(argv)
    validate_file_list(args.pats)
    for name in ("col_wrap", "space_rows", "space_cols", "circle_size",
                 "font_size", "line_width", "top"):
        if getattr(args, name) <= 0:
            raise IllegalArgumentError(f"Invalid {name} flag: must be "
                                       "positive")

    g = Genome(args.genome)
    gr = GenomicRegion(region=args.region, sites=args.sites, genome=g,
                       no_anno=args.no_anno)
    if gr.is_whole():
        raise IllegalArgumentError("pat_fig requires a region (-r or -s)")

    # de-dup, keeping order; optional rename table filter
    pats = list(dict.fromkeys(args.pats))
    dnames = {}
    if args.name_table:
        try:
            import csv

            with open(args.name_table) as f:
                dnames = {row[0]: row[1] for row in csv.reader(f) if row}
        except Exception:
            print(f"[wt pat_fig] failed loading names table "
                  f"{args.name_table}. using original file names",
                  file=sys.stderr)
        if dnames:
            pats = [q for q in pats if pretty_name(q) in dnames]
            if not pats:
                print(f"[wt pat_fig] ERROR: no pat files found in "
                      f"{args.name_table}", file=sys.stderr)
                return 1

    tables = []
    for pat in pats:
        frags = view_pat(pat, g, sites=f"{gr.sites[0]}-{gr.sites[1]}",
                         strict=args.strict, strip=args.strip,
                         min_len=args.min_len, no_gaps=args.no_gaps,
                         sub_sample=args.sub_sample, seed=args.seed,
                         no_sort=args.no_sort)
        if args.shuffle:
            frags = _shuffle_within_start(frags, args.seed)
        packed = pack_reads_to_table(frags, gr.sites[0], gr.sites[1],
                                     max_reps=args.max_reps,
                                     no_dense=args.no_dense, uxm=args.uxm)
        if packed is None:
            t = np.zeros((0, 0), dtype=np.int64)
        else:
            chars = packed[0][: args.top, ]
            t = _FIG_LUT[chars]
        nr_sites = gr.sites[1] - gr.sites[0]
        width = max(nr_sites + 1, t.shape[1]) + args.space_cols
        tables.append(_fig_pad(t, args.top + args.space_rows, width))

    # tile col_wrap tables per figure row, trimming trailing empty lines
    tmp = []
    nr_pats = len(pats)
    step = min(args.col_wrap, nr_pats)
    for i in range(0, nr_pats, step):
        row = np.hstack(tables[i:i + step])
        nr_lines = int(np.argmin(row.sum(axis=1))) + args.space_rows
        tmp.append(row[:nr_lines, :])
    max_width = max(t.shape[1] for t in tmp)
    table = np.vstack([_fig_pad(t, None, max_width) for t in tmp])

    # header (sample name) positions
    headers = []
    shifty = shiftx = s = 0
    for i in range(nr_pats):
        name = pretty_name(pats[i])
        name = dnames.get(name, name)[: args.max_name_chars]
        headers.append((shiftx, table.shape[0] - shifty + 2, name))
        shiftx += tables[i].shape[1]
        if step == 1 or ((i + 1) % step == 0 and i > 0):
            shifty += tmp[s].shape[0]
            shiftx = 0
            s += 1

    if table.sum() == 0:
        print(f"[wt vis] WARNING: empty table for region {gr}",
              file=sys.stderr)
        return 0
    _plot_fig_table(table, headers, gr, args)
    print(f"[wt pat_fig] saved {args.outpath}")
    return 0
