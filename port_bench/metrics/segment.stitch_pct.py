"""segment.stitch_pct: percent of the traced jobs' wall in the stitching of
chunk borders (finalize_segmentation, timings['stitch'])."""


def read(run):
    if run.job != "segment":
        return None
    return run.share('stitch')
