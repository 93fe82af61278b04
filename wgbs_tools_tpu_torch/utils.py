"""Host utilities of the port: errors, stderr, the logger, file paths.

The port's own copy of what it calls from wgbs_tools_tpu/utils/
(`__init__.py`, `log.py`, `files.py`; ref: src/python/utils_wgbs.py),
with the same names: the CLI's input checks (`validate_single_file`,
`validate_file_list`), output names (`pretty_name`, `mkdirp`),
`set_verbose` and the decode's `outer_add` among them.
"""

import logging
import os
import os.path as op
import sys
from pathlib import Path

logger = logging.getLogger("wgbs_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[wt %(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class IllegalArgumentError(ValueError):
    pass


def eprint(*args, **kwargs):
    print(*args, file=sys.stderr, **kwargs)


def splitextgz(input_file):
    """fname.pat.gz -> (fname, '.pat.gz'); fname.beta -> (fname, '.beta')."""
    b, suff = op.splitext(input_file)
    if suff == ".gz":
        b, suff2 = op.splitext(b)
        suff = suff2 + suff
    return b, suff


def pretty_name(fpath):
    return splitextgz(op.basename(fpath))[0]


def mkdirp(dpath):
    if dpath:
        Path(dpath).mkdir(parents=True, exist_ok=True)
    return dpath


def delete_or_skip(output_file, force):
    """Idempotency at file granularity (ref: utils_wgbs.py:435-454):
    existing output + force -> delete; existing + no force -> skip (False)."""
    if output_file is None or output_file == sys.stdout \
            or output_file == "/dev/stdout":
        return True
    if op.isfile(output_file):
        if force:
            for f in (output_file, output_file + ".csi", output_file + ".cdx",
                      output_file + ".cdx.npz"):
                if op.isfile(f):
                    os.remove(f)
        else:
            eprint(f"File {output_file} already exists. Skipping it. "
                   "Use [-f] flag to force overwrite.")
            return False
    return True


def validate_single_file(fpath, suff=None):
    if fpath is None:
        raise IllegalArgumentError("Input file is None")
    if not op.isfile(fpath):
        raise IllegalArgumentError(f"No such file: {fpath}")
    if suff is not None and not fpath.endswith(suff):
        raise IllegalArgumentError(f"file {fpath} must end with {suff}")
    return fpath


def validate_file_list(files, force_suff=None, min_len=1):
    if len(files) < min_len:
        raise IllegalArgumentError(
            f"Input error: at least {min_len} input files must be given"
        )
    first = files[0]
    if len(first) == 1:
        raise IllegalArgumentError(f"Input is not a list of files: {files}")
    if force_suff is not None and not first.endswith(force_suff):
        raise IllegalArgumentError(f"Input file {first} must end with {force_suff}")
    suff = splitextgz(first)[1]
    for fpath in files:
        validate_single_file(fpath, suff)


def set_verbose():
    """--verbose/--debug CLI flags: log at debug level
    (ref: bam2pat.py:205-206 prints the shell commands when verbose)."""
    logger.setLevel(logging.DEBUG)


def outer_add(col, n, dtype=None):
    """col[:, None] + arange(n), built by filling then adding: numpy's
    outer-broadcast ufunc path ((N,1)+(1,n)) runs much slower on short
    rows, and the BAM decode builds its index matrices through this."""
    import numpy as np

    col = np.asarray(col)
    dtype = np.dtype(dtype or col.dtype)
    out = np.empty((col.shape[0], n), dtype=dtype)
    out[:] = np.arange(n, dtype=dtype)
    out += col[:, None].astype(dtype, copy=False)
    return out
