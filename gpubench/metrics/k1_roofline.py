"""``k1_roofline``: K1's share of its roofline, in %.

Layer: K1, the de novo sampler kernel (``ops/cuda_denovo.py`` +
``csrc/denovo_sampler.cu``).  The least time of the work that the
window's de novo sampling needs, over the device time of K1's kernels in
the profiler's trace.

The work is counted from MCHap's de novo sampler (v0.11.1,
``assemble/mcmc``), at each problem's real inputs, not from K1's source
or its padded buckets, so a rewrite of K1 leaves it as it is.  A step of
a chain at one temperature rung runs a Gibbs sweep over the SNVs that the
homozygosity screen leaves free: for each such SNV j with A_j alleles and
each of the P haplotypes, each of the A_j - 1 other alleles is scored
over each of the problem's R distinct reads (the haplotype's read
probability scaled, 1 multiply; the genotype's read probability updated,
2 adds; its log, 1 transcendental; weighted into the option's
log-likelihood, 1 multiply-add: 5 flops), and the A_j options are drawn
from by their exponentials (A_j transcendentals).  The structural steps
(recombination, dosage swaps) draw their options at random, so their
work depends on the draws and is left out: the count is a lower bound.
Bytes: each problem's read probabilities (f32, R x A_j per free SNV) and
read counts read once, and its trace written once (one byte per
haplotype and free SNV, per step and chain, and an f32 log-likelihood).
Moves ``loci_per_s``.
"""

from gpubench.metrics._work import add, least_seconds

UNIT = "%"
KERNELS = r"\bdenovo_(?:ladder_)?kernel\b"


def problem_work(p, cell):
    """Work of one (locus, sample) problem over all its chains, rungs and steps."""
    P, R, free = cell["ploidy"], p["reads"], p["free_alleles"]
    opts = sum(a - 1 for a in free)
    runs = cell["chains"] * len(cell["temperatures"]) * cell["steps"]
    flops = P * opts * R * 5
    trans = P * (opts * R + sum(free))
    out_bytes = cell["chains"] * cell["steps"] * (P * len(free) + 4)
    return dict(flops=float(flops * runs), transcendentals=float(trans * runs),
                bytes=float(4 * R * (sum(free) + 1) + out_bytes))


def window_work(ctx):
    total = dict(flops=0.0, transcendentals=0.0, bytes=0.0)
    for j in ctx["jobs"]:
        if j["ok"]:
            for p in j["problems"]:
                if p.get("free_alleles"):
                    total = add(total, problem_work(p, ctx["cell"]))
    return total


def read(ctx):
    seconds = ctx["kernel_seconds"](KERNELS)
    least = least_seconds(window_work(ctx), ctx["card"])
    if not seconds or least is None:
        return None
    return 100.0 * least / seconds
