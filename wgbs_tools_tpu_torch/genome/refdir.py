"""Genome reference directories.

The port's copy of wgbs_tools_tpu/genome/refdir.py: the
`references/<name>/` layout with a `default` symlink (ref:
src/python/utils_wgbs.py:53-115, set_default_ref.py:35-49), rooted at
$WGBS_TPU_REFDIR (default: <repo>/references, made at first use); the
genome's number of CpG sites, read from the CpG index that `init_genome`
writes (`cpg_index.npz` + `cpg_index.json`); the whole index
(`genome/cpg_index.py::CpGIndex`), loaded at first use; and the files in
the directory (`join`, `annotations`, `blocks`, `blacklist`, `whitelist`,
`ilmn2cpg_dict`).
"""

import os
import os.path as op
from pathlib import Path

import numpy as np

from ..utils import IllegalArgumentError, mkdirp
from .cpg_index import INDEX_BASENAME, META_BASENAME, CpGIndex


def references_root():
    env = os.environ.get("WGBS_TPU_REFDIR")
    if env:
        return mkdirp(env)
    pkg_root = Path(op.realpath(__file__)).parent.parent.parent
    return mkdirp(op.join(str(pkg_root), "references"))


def genome_dir(name=None):
    name = name or "default"
    refdir = op.join(references_root(), name)
    if name == "default":
        if not op.islink(refdir):
            raise IllegalArgumentError(
                "No default genome set. Run init_genome or set_default_ref.")
        refdir = str(Path(refdir).resolve())
    if not op.isdir(refdir):
        raise IllegalArgumentError(f"Invalid reference name: {name}")
    return refdir


def resolve_genome_name(name=None):
    if name is None or name == "default":
        refdir = op.join(references_root(), "default")
        if not op.islink(refdir):
            raise IllegalArgumentError("No default genome set.")
        return os.readlink(refdir)
    return name


def set_default_ref(name):
    """Point the `default` symlink at references/<name>."""
    root = references_root()
    target = op.join(root, name)
    if not op.isdir(target):
        raise IllegalArgumentError(f"Invalid reference name: {name}")
    link = op.join(root, "default")
    if op.islink(link):
        os.unlink(link)
    elif op.exists(link):
        raise IllegalArgumentError(f"{link} exists and is not a symlink")
    os.symlink(name, link)


class Genome:
    """A genome of the reference directory: its name, its directory, its
    number of CpG sites (loaded at the first get_nr_sites, without the
    rest of the index) and its CpGIndex (loaded at the first `index`)."""

    def __init__(self, name=None):
        self.name = resolve_genome_name(name)
        self.refdir = genome_dir(name)
        self._nr_sites = None
        self._index = None

    @property
    def index(self) -> CpGIndex:
        if self._index is None:
            self._index = CpGIndex.load(self.refdir, name=self.name)
        return self._index

    def join(self, fname, validate=False):
        """The path of `fname` in the genome's directory (or of its .gz),
        or None (with validate, an error) when neither exists."""
        path = op.join(self.refdir, fname)
        if not op.isfile(path):
            if op.isfile(path + ".gz"):
                return path + ".gz"
            if validate:
                raise IllegalArgumentError(f"Invalid reference path: {path}")
            return None
        return path

    @property
    def annotations(self):
        return self.join("annotations.bed.gz")

    @property
    def blocks(self):
        return self.join("blocks.bed.gz")

    @property
    def blacklist(self):
        return self.join("blacklist.bed")

    @property
    def whitelist(self):
        return self.join("whitelist.bed")

    @property
    def ilmn2cpg_dict(self):
        return self.join("ilmn2CpG.tsv.gz")

    def get_chroms(self):
        return tuple(self.index.chrom_names)

    def get_nr_sites(self):
        if self._nr_sites is None:
            npz_path = op.join(self.refdir, INDEX_BASENAME)
            if not (op.isfile(npz_path)
                    and op.isfile(op.join(self.refdir, META_BASENAME))):
                raise IllegalArgumentError(
                    f"Not an initialized genome dir: {self.refdir}")
            with np.load(npz_path) as z:
                self._nr_sites = int(z["loci"].shape[0])
        return self._nr_sites
