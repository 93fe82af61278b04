"""find_markers: differentially-methylated region discovery across sample
groups (ref: src/python/find_markers.py, fm_load_params.py, dmb.py).

The screening pipeline per target group: coverage/NA filters, U/M direction
scans with mean + quantile delta thresholds, then t-test / Mann-Whitney /
M-value t-test column statistics. Defaults mirror
supplemental/find_markers_defaults.txt.

The port's copy of wgbs_tools_tpu/models/markers.py without pandas. JAX
holds the groups and the block table in pandas frames; here a `_Table` of
numpy columns (insertion-ordered, like a frame's) does the same row
filters, and the three places where pandas decides the bytes are copied:
the groups csv's parse (`_read_groups_csv`: pandas' comment, NA and type
rules for the columns read), the descending sort of --sort_by
(`_nargsort`, pandas.core.sorting.nargsort: numpy's quicksort on the
reversed non-NaN values, NaNs last) and the tab-separated writer
(`_write_table`: csv.writer's minimal quoting, ints as ints, floats
through "%.3g" and NaN as "NA"). The blocks' sums run in
cli/cmd_beta.py::reduce_beta_to_blocks on `devices` (the block_sums
kernel on cuda, its twin on the CPU); the statistics stay in scipy.stats
on numpy arrays.
"""

import csv
import os.path as op
import re

import numpy as np

from ..formats.beta import beta2vec
from ..formats.blocks import load_blocks
from ..utils import IllegalArgumentError, eprint, mkdirp, pretty_name

DEFAULTS = dict(
    blocks_path=None, groups_file=None, targets=None, background=None,
    betas=None, min_bp=0, max_bp=10_000_000_000, min_cpg=0,
    max_cpg=10_000_000_000, min_cov=5, na_rate_tg=0.334, na_rate_bg=0.334,
    only_hyper=False, only_hypo=False, delta_means=0.3, delta_quants=0.0,
    tg_quant=0.25, bg_quant=0.025, unmeth_quant_thresh=1.0,
    meth_quant_thresh=0.0, unmeth_mean_thresh=1.0, meth_mean_thresh=0.0,
    out_dir=".", top=None, header=False, verbose=False, chunk_size=150000,
    pval=0.05, test_type="t", sort_by=None, delta_maxmin=-1,
)


class MarkerParams:
    """Layered config: defaults < config file < explicit kwargs
    (ref: fm_load_params.py:14-44)."""

    def __init__(self, config_file=None, **kwargs):
        for k, v in DEFAULTS.items():
            setattr(self, k, v)
        if config_file:
            for k, v in _load_param_file(config_file).items():
                setattr(self, k, v)
        for k, v in kwargs.items():
            if v is None:
                continue
            if isinstance(v, bool) and not v:
                continue
            setattr(self, k, v)
        self.validate()

    def validate(self):
        if self.only_hyper and self.only_hypo:
            raise IllegalArgumentError(
                "at most one of (only_hyper, only_hypo) can be specified")
        for key in ("na_rate_tg", "na_rate_bg", "tg_quant", "bg_quant",
                    "unmeth_quant_thresh", "meth_quant_thresh",
                    "unmeth_mean_thresh", "meth_mean_thresh", "pval"):
            v = float(getattr(self, key))
            if not 0 <= v <= 1:
                raise IllegalArgumentError(f"{key} must be in [0, 1]")
        for key in ("delta_means", "delta_quants", "delta_maxmin"):
            v = float(getattr(self, key))
            if not -1 <= v <= 1:
                raise IllegalArgumentError(f"{key} must be in [-1, 1]")
        if self.test_type not in ("t", "mw", "m_t"):
            raise IllegalArgumentError("test_type must be t, mw or m_t")

    def as_dict(self):
        return {k: getattr(self, k) for k in DEFAULTS}


def _load_param_file(path):
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or ":" not in line:
                continue
            key, val = line.split(":", 1)
            val = val.strip()
            if val in ("NA", "None", ""):
                val = None
            elif val == "True":
                val = True
            elif val == "False":
                val = False
            elif key.strip() == "targets":
                val = val.split()
            else:
                try:
                    val = int(val)
                except ValueError:
                    try:
                        val = float(val)
                    except ValueError:
                        pass
            out[key.strip()] = val
    return out


# ------------------------------------------------------------ a numpy table


class _Table:
    """Named numpy columns of one length, in insertion order: the part of a
    pandas frame the scan uses (row filters, column matrices)."""

    def __init__(self, cols=None, n=0):
        self.cols = dict(cols or {})
        self.n = len(next(iter(self.cols.values()))) if self.cols else n

    @property
    def empty(self):
        return self.n == 0 or not self.cols

    def __getitem__(self, name):
        return self.cols[name]

    def __setitem__(self, name, values):
        if np.ndim(values) == 0:
            values = np.full(self.n, values)
        self.cols[name] = np.asarray(values)

    def matrix(self, names):
        """(rows, len(names)) float64, a column a name (repeats kept)."""
        return np.column_stack([self.cols[k] for k in names]).astype(
            np.float64, copy=False) if names else np.zeros((self.n, 0))

    def take(self, rows):
        """The rows by a boolean mask or an index array, in that order."""
        rows = np.asarray(rows)
        n = int(rows.sum()) if rows.dtype == bool else len(rows)
        return _Table({k: v[rows] for k, v in self.cols.items()}, n)

    def copy(self):
        return _Table({k: v.copy() for k, v in self.cols.items()}, self.n)


def _concat(tables):
    """Row concatenation of tables with the same columns (pd.concat)."""
    if len(tables) == 1:
        return tables[0]
    return _Table({k: np.concatenate([t.cols[k] for t in tables])
                   for k in tables[0].cols})


# ------------------------------------------------------------ groups file

# pandas.read_csv's default NA strings (pandas/_libs/parsers.pyx
# STR_NA_VALUES)
_NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_TRUE = frozenset(("True", "TRUE", "true"))
_FALSE = frozenset(("False", "FALSE", "false"))
_INT_RE = re.compile(r"^[+-]?\d+$")


def _is_float(tok):
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _typed(tokens):
    """A column's values as pd.read_csv infers them: None for an NA token;
    ints when every other token is an integer (floats when an NA is
    among them), floats when every one parses as a float, bools for
    True/False tokens, else the strings."""
    vals = [t for t in tokens if t is not None]
    if vals and all(_INT_RE.match(t) for t in vals):
        conv = float if len(vals) < len(tokens) else int
        return [None if t is None else conv(t) for t in tokens]
    if vals and all(_is_float(t) for t in vals):
        return [None if t is None else float(t) for t in tokens]
    if vals and all(t in _TRUE or t in _FALSE for t in vals):
        return [None if t is None else t in _TRUE for t in tokens]
    return list(tokens)


def _read_groups_csv(path):
    """(header, {column: values}) of a groups csv, as
    pd.read_csv(path, index_col=False, comment="#") reads it: text after a
    '#' dropped, blank lines and comment lines skipped, the first line
    left the header,
    short rows padded with NA; a row longer than the header raises, as
    pandas does."""
    with open(path, newline="") as f:
        # a blank line is skipped, and so is one that a comment starts; a
        # line of blanks before a comment is a row
        lines = [line.split("#", 1)[0] for line in f.read().splitlines()
                 if line.strip()]
    rows = list(csv.reader(line for line in lines if line))
    if not rows:
        raise IllegalArgumentError(f"empty groups file: {path}")
    header, data = rows[0], rows[1:]
    for r in data:
        if len(r) > len(header):
            raise IllegalArgumentError(
                f"{path}: expected {len(header)} fields, saw {len(r)}")
    cols = {}
    for j, name in enumerate(header):
        tokens = [r[j] if j < len(r) else "" for r in data]
        cols[name] = _typed([None if t in _NA_STRINGS else t
                             for t in tokens])
    return header, cols


def load_groups(groups_file, betas):
    """The rows of a groups csv (ref: dmb.py:24-80) as {"fname", "group",
    "full_path"} lists: rows whose `include` is False dropped, the first
    column read as the sample name, rows without a name or a group
    dropped."""
    header, cols = _read_groups_csv(groups_file)
    if "group" not in cols:
        raise IllegalArgumentError('groups file must have a "group" column')
    keep = range(len(cols["group"]))
    if "include" in cols:
        inc = cols["include"]
        if not all(isinstance(v, bool) for v in inc):
            raise IllegalArgumentError(
                'the "include" column must hold True / False')
        keep = [i for i in keep if inc[i]]
    names = cols[header[0]]
    groups = cols["group"]
    keep = [i for i in keep if names[i] is not None
            and groups[i] is not None]
    gf = {"fname": [str(names[i]) for i in keep],
          "group": [groups[i] for i in keep]}
    name2path = {}
    for prefix in gf["fname"]:
        matches = [b for b in betas
                   if op.basename(b) in (prefix + ".beta", prefix + ".lbeta")
                   or pretty_name(b) == prefix]
        if not matches:
            raise IllegalArgumentError(f"no beta file for prefix {prefix}")
        name2path[prefix] = matches[0]
    gf["full_path"] = [name2path[f] for f in gf["fname"]]
    return gf


def _unique(values):
    """The values in first-seen order (pandas' unique / drop_duplicates)."""
    return list(dict.fromkeys(values))


def build_block_table(blocks, gf, min_cov, devices=None):
    """blocks x samples methylation matrix (NaN below min_cov); each
    sample's block sums from reduce_beta_to_blocks on `devices`."""
    from ..cli.cmd_beta import reduce_beta_to_blocks

    table = {}
    seen = set()
    for fname, path in zip(gf["fname"], gf["full_path"]):
        if fname in seen:
            continue
        seen.add(fname)
        reduced = reduce_beta_to_blocks(path, blocks, devices=devices)
        table[fname] = beta2vec(reduced, min_cov=min_cov)
    df = _Table({k: blocks[k] for k in ("chr", "start", "end", "startCpG",
                                        "endCpG")})
    for k, v in table.items():
        df[k] = v
    return df


# ------------------------------------------------------------ the scan


def _find_x_markers(tf, tg_names, bg_names, p, tg_quant, bg_quant):
    """Direction scan (ref: find_markers.py:335-369). tg = hypo group."""
    import warnings

    tfX = tf.copy()
    tg, bg = tfX.matrix(tg_names), tfX.matrix(bg_names)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        tfX["delta_maxmin"] = np.nanmin(bg, axis=1) - np.nanmax(tg, axis=1)
        tfX["tg_mean"] = np.nanmean(tg, axis=1)
        tfX["bg_mean"] = np.nanmean(bg, axis=1)
    tfX["delta_means"] = tfX["bg_mean"] - tfX["tg_mean"]
    keep = (
        (tfX["tg_mean"] <= p.unmeth_mean_thresh)
        & (tfX["bg_mean"] >= p.meth_mean_thresh)
        & (tfX["delta_means"] >= p.delta_means)
        & (tfX["delta_maxmin"] >= p.delta_maxmin)
    )
    tfX = tfX.take(keep)
    if tfX.empty:
        return tfX
    with np.errstate(all="ignore"):
        tfX["tg_quant"] = np.nanquantile(tfX.matrix(tg_names), 1 - tg_quant,
                                         axis=1)
        tfX["bg_quant"] = np.nanquantile(tfX.matrix(bg_names), bg_quant,
                                         axis=1)
    tfX["delta_quants"] = tfX["bg_quant"] - tfX["tg_quant"]
    keep = (
        (tfX["tg_quant"] <= p.unmeth_quant_thresh)
        & (tfX["bg_quant"] >= p.meth_quant_thresh)
        & (tfX["delta_quants"] >= p.delta_quants)
    )
    return tfX.take(keep)


def _pvalues(res):
    """A scipy result's p-values as float64 (masked entries NaN)."""
    return np.ma.filled(np.ma.asarray(res.pvalue, dtype=np.float64), np.nan)


def _add_tests(tf, tg_names, bg_names, p):
    """t-test / MW / M-value t-test columns (ref: find_markers.py:203-316)."""
    from scipy.stats import mannwhitneyu, ttest_1samp, ttest_ind

    if tf.empty:
        return tf

    def _tt(a, b, equal_var=True):
        if len(tg_names) == len(bg_names) == 1:
            return np.full(tf.n, np.nan)
        if a.shape[1] == 1:
            return _pvalues(ttest_1samp(b, a, axis=1, nan_policy="omit"))
        if b.shape[1] == 1:
            return _pvalues(ttest_1samp(a, b, axis=1, nan_policy="omit"))
        return _pvalues(ttest_ind(a, b, axis=1, nan_policy="omit",
                                  equal_var=equal_var))

    tf = tf.copy()
    tf["ttest"] = _tt(tf.matrix(tg_names), tf.matrix(bg_names))
    if p.test_type == "t":
        tf = tf.take(~(tf["ttest"] > p.pval))
        if tf.empty:
            return tf

    if len(tg_names) == len(bg_names) == 1:
        tf["mw_test"] = np.nan
    else:
        try:
            r = mannwhitneyu(tf.matrix(tg_names), tf.matrix(bg_names),
                             axis=1, nan_policy="omit",
                             alternative="two-sided")
            tf["mw_test"] = _pvalues(r)
        except Exception:
            tf["mw_test"] = np.nan
    if p.test_type == "mw":
        tf = tf.take(~(tf["mw_test"] > p.pval))
        if tf.empty:
            return tf

    def _mvalues(names):
        c = np.clip(tf.matrix(names), 1e-4, 1 - 1e-4)
        return np.log2(c / (1 - c))

    tf["mvalue_ttest"] = _tt(_mvalues(tg_names), _mvalues(bg_names),
                             equal_var=False)
    if p.test_type == "m_t":
        tf = tf.take(~(tf["mvalue_ttest"] > p.pval))
    return tf


def find_markers(params: MarkerParams, betas, blocks_path=None,
                 groups_file=None, devices=None):
    """Run the full marker scan; returns {target: _Table} and writes
    Markers.<group>.bed + params.txt under out_dir. The blocks' sums run
    on `devices` (parallel/mesh.py::shard_devices; default: every visible
    card)."""
    p = params
    blocks_path = blocks_path or p.blocks_path
    groups_file = groups_file or p.groups_file
    if not blocks_path or not groups_file:
        raise IllegalArgumentError("blocks_path and groups_file are required")

    gf = load_groups(groups_file, betas)
    groups = sorted(_unique(gf["group"]))
    targets = p.targets if p.targets else groups
    background = p.background if p.background else groups

    blocks = load_blocks(blocks_path)
    lencpg = blocks["endCpG"] - blocks["startCpG"]
    lenbp = blocks["end"] - blocks["start"]
    keep = (
        (blocks["startCpG"] >= 0)
        & (lencpg >= p.min_cpg) & (lencpg <= p.max_cpg)
        & (lenbp >= p.min_bp) & (lenbp <= p.max_bp)
    )
    blocks = {k: v[keep] for k, v in blocks.items()}

    mkdirp(p.out_dir)
    _dump_params(p, betas)

    df = build_block_table(blocks, gf, p.min_cov, devices=devices)
    results = {}
    for target in targets:
        tg_names = [f for f, g in zip(gf["fname"], gf["group"])
                    if g == target]
        bg_names = [
            s for s in _unique(f for f, g in zip(gf["fname"], gf["group"])
                               if g in background)
            if s not in tg_names
        ]
        if not bg_names or not tg_names:
            continue
        keep_tg = ((~np.isnan(df.matrix(tg_names))).sum(axis=1)
                   / len(tg_names) >= 1 - p.na_rate_tg)
        keep_bg = ((~np.isnan(df.matrix(bg_names))).sum(axis=1)
                   / len(bg_names) >= 1 - p.na_rate_bg)
        tf = df.take(keep_tg & keep_bg)

        frames = []
        if not p.only_hyper:  # U (hypo) markers
            tfU = _find_x_markers(tf, tg_names, bg_names, p, p.tg_quant,
                                  p.bg_quant)
            if not tfU.empty:
                tfU["direction"] = "U"
                frames.append(tfU)
        if not p.only_hypo:  # M (hyper) markers: swap roles
            tfM = _find_x_markers(tf, bg_names, tg_names, p, p.bg_quant,
                                  p.tg_quant)
            if not tfM.empty:
                tfM["tg_mean"], tfM["bg_mean"] = (tfM["bg_mean"].copy(),
                                                  tfM["tg_mean"].copy())
                tfM["direction"] = "M"
                frames.append(tfM)
        tf = _concat(frames) if frames else _Table()
        tf = _add_tests(tf, tg_names, bg_names, p)
        results[target] = tf
        _dump_group(tf, target, tg_names, bg_names, p)
    return results


# ------------------------------------------------------------ output

_COLS = ["chr", "start", "end", "startCpG", "endCpG", "target", "region",
         "lenCpG", "bp", "tg_mean", "bg_mean", "delta_means", "delta_quants",
         "delta_maxmin", "ttest", "mw_test", "mvalue_ttest", "direction"]


def _isna(values):
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype.kind == "O":
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in values], dtype=bool)
    return np.zeros(values.shape, dtype=bool)


def _nargsort(items, ascending=True):
    """The order DataFrame.sort_values gives a column, NaNs last.

    A numeric column sorts as pandas.core.sorting.nargsort sorts numpy
    values (kind "quicksort"). A text column sorts as pandas sorts a
    string column backed by Arrow (pandas 3's default `str` dtype): a
    stable sort, so tied rows keep their row order in either direction."""
    mask = _isna(items)
    idx = np.arange(len(items))
    non_nans = items[~mask]
    non_nan_idx = idx[~mask]
    nan_idx = np.nonzero(mask)[0]
    if items.dtype.kind in "OUS":
        vals = non_nans.tolist()
        order = sorted(range(len(vals)), key=vals.__getitem__,
                       reverse=not ascending)
        return np.concatenate([non_nan_idx[order], nan_idx]).astype(np.int64)
    if not ascending:
        non_nans = non_nans[::-1]
        non_nan_idx = non_nan_idx[::-1]
    indexer = non_nan_idx[non_nans.argsort(kind="quicksort")]
    if not ascending:
        indexer = indexer[::-1]
    return np.concatenate([indexer, nan_idx])


def _cells(values):
    """A column's csv cells as pandas' to_csv(na_rep="NA",
    float_format="%.3g") writes them."""
    if values.dtype.kind == "f":
        return ["NA" if v != v else "%.3g" % v for v in values.tolist()]
    return ["NA" if v is None else str(v) for v in values.tolist()]


def _write_table(path, mode, header, columns):
    """Tab-separated rows through csv.writer, as pandas' to_csv writes
    them (minimal quoting, "\\n" line ends)."""
    with open(path, mode, newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n",
                       quoting=csv.QUOTE_MINIMAL)
        w.writerow(header)
        w.writerows(zip(*[_cells(c) for c in columns]))


def _dump_group(tf, group, tg_names, bg_names, p):
    eprint(f"[wt fm] {group}: {tf.n:,} markers")
    outpath = op.join(p.out_dir, f"Markers.{group}.bed")
    if tf.empty:
        columns = [np.zeros(0) for _ in _COLS]
    else:
        out = tf.copy()
        if p.sort_by:
            out = out.take(_nargsort(out[p.sort_by], ascending=False))
        if p.top:
            out = out.take(np.arange(min(int(p.top), out.n)))
        out["target"] = group
        out["lenCpG"] = np.array([f"{d}CpGs" for d in (
            out["endCpG"] - out["startCpG"]).tolist()], dtype=object)
        out["bp"] = np.array([f"{d}bp" for d in (
            out["end"] - out["start"]).tolist()], dtype=object)
        out["region"] = np.array(
            [f"{c}:{s}-{e}" for c, s, e in zip(out["chr"].tolist(),
                                               out["start"].tolist(),
                                               out["end"].tolist())],
            dtype=object)
        columns = [out[k] for k in _COLS]
    mode = "w"
    if p.header:
        with open(outpath, "w") as f:
            for s in sorted(tg_names):
                f.write(f"#> {s}\n")
            for s in sorted(bg_names):
                f.write(f"#< {s}\n")
        mode = "a"
    _write_table(outpath, mode, ["#chr"] + _COLS[1:], columns)


def _dump_params(p, betas):
    with open(op.join(p.out_dir, "params.txt"), "w") as f:
        for key, val in p.as_dict().items():
            if key == "betas":
                val = " ".join(betas)
            elif key == "targets" and val is not None:
                val = " ".join(val)
            f.write(f"{key}:{val}\n")
