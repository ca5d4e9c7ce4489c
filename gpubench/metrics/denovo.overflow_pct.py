"""``denovo.overflow_pct``: the share of the sampler's problems whose
de novo trace takes the tabulation's overflow route, in %.

Layer: posterior and VCF.  Past 512 distinct states in a chain the
program fetches a problem's whole kept trace and tabulates it on the
host (``models/assemble.py``: route ``overflow-full-fetch``, then
``host.posterior_tab`` inside ``posterior.samples``).  100 x the
program's counter ``denovo.overflow_problems`` over its counter
``sampler.problems``, summed over the window's jobs (``jobs.run_job``
keeps them on the traced run); None where no job has counters.  Moves
``loci_per_s``.
"""

UNIT = "%"


def read(ctx):
    jobs = [j for j in ctx["jobs"] if j["ok"] and j.get("counters")]
    problems = sum(j["counters"].get("sampler.problems", 0) for j in jobs)
    if not problems:
        return None
    return 100.0 * sum(j["counters"].get("denovo.overflow_problems", 0) for j in jobs) / problems
