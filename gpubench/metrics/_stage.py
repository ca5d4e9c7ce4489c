"""Shared by the stage readers: a program stage's seconds per locus."""


def ms_per_locus(ctx, stage):
    """Milliseconds of the program's top-level ``stage`` per locus, over
    the window's jobs (``utils/timing`` with ``MCHAP_TIMING=1``)."""
    jobs = [j for j in ctx["jobs"] if j["ok"]]
    loci = sum(j["loci"] for j in jobs)
    if not loci or not any(stage in j["stages"] for j in jobs):
        return None
    return 1e3 * sum(j["stages"].get(stage, 0.0) for j in jobs) / loci
