"""pat2beta.stage_sites_per_s: sites staged a second of host staging: the
program's counter pileup.sites (the sites spanned by the lines each
PileupAccumulator.add stages) over the seconds of its span pileup.stage."""

from port_bench.spans import rate


def read(run):
    if run.job != "pat2beta":
        return None
    return rate(run, "pileup.sites", "pileup.stage")
