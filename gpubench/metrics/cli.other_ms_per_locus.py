"""``cli.other_ms_per_locus``: a job's wall time outside the program's
top-level stages, in ms per locus.

Layer: the CLI and its locus blocks (``application/{cli,baseclass,
assemble,call}.py``): argument parsing, the VCF header, building the
loci, grouping problems into blocks.  The job's wall time is the
benchmark's clock; the stages (``read_loci``, ``encode_reads``,
``device_sampler``, ``summarize_format``, which do not nest in one
another) are the program's.  Moves ``loci_per_s``.
"""

UNIT = "ms/locus"
TOP_STAGES = ("read_loci", "encode_reads", "device_sampler", "summarize_format")


def read(ctx):
    jobs = [j for j in ctx["jobs"] if j["ok"]]
    loci = sum(j["loci"] for j in jobs)
    if not loci or not any(j["stages"] for j in jobs):
        return None
    other = sum(j["wall_s"] - sum(j["stages"].get(s, 0.0) for s in TOP_STAGES) for j in jobs)
    return 1e3 * other / loci
