"""pat-centric command helpers: the port's copy of
wgbs_tools_tpu/cli/cmd_pat.py's `_concat_frags`, which bam2pat (the
chromosomes' batches) and the sorted stream emitter use; the commands of
that file (merge, mix_pat, mask_pat, index, frag_len) are not ported yet.
"""

import numpy as np

from ..formats.pat import PatFrags
from ..utils import IllegalArgumentError


def _concat_frags(frag_list, labels=None):
    if not frag_list:
        raise IllegalArgumentError("no fragments to merge")
    max_len = max(f.max_len for f in frag_list)
    chrom_names = []
    lookup = {}
    parts = []
    for k, f in enumerate(frag_list):
        codes = f.codes
        if codes.shape[1] < max_len:
            codes = np.pad(codes, ((0, 0), (0, max_len - codes.shape[1])),
                           constant_values=3)
        # chrom-name union across inputs
        ids = []
        for c in f.chrom_names:
            if c not in lookup:
                lookup[c] = len(chrom_names)
                chrom_names.append(c)
            ids.append(lookup[c])
        idmap = np.array(ids, dtype=np.int16)
        cid = idmap[f.chrom_id] if len(ids) else f.chrom_id
        extras = f.extras
        if labels is not None:
            lab = labels[k].encode()
            base = f.extras if f.extras is not None else np.array(
                [None] * f.nr_frags, dtype=object)
            extras = np.array(
                [lab if b is None else b + b"\t" + lab for b in base],
                dtype=object,
            )
        parts.append((f.start, f.length, f.count, codes, cid, extras))
    has_extras = any(p[5] is not None for p in parts)
    if has_extras:
        for i, pp in enumerate(parts):
            if pp[5] is None:
                parts[i] = pp[:5] + (np.array([None] * len(pp[0]), dtype=object),)
    return PatFrags(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        np.concatenate([p[2] for p in parts]),
        np.concatenate([p[3] for p in parts]),
        np.concatenate([p[4] for p in parts]),
        chrom_names,
        np.concatenate([p[5] for p in parts]) if has_extras else None,
    )
