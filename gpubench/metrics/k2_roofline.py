"""``k2_roofline``: K2's share of its roofline, in %.

Layer: K2, the calling sampler kernel (``ops/cuda_calling.py`` +
``csrc/calling_sampler.cu``).  The least time of the work that the
window's calling needs, over the device time of K2's kernels in the
profiler's trace.

The work is counted from MCHap's calling sampler (v0.11.1,
``calling/mcmc``, Gibbs steps), at each problem's real inputs: a step of
a chain visits the P allele slots in turn; at each, the other slots'
read probabilities are summed once per distinct read (the slot's own
taken out: 1 add per read), and each of the H haplotypes the sampler
chooses among (the panel's, less those the prior rules out) is scored
over the R distinct reads (its read probability added, 1 add; the log,
1 transcendental; weighted in, 1 multiply-add: 3 flops), plus its prior
term (1 add) and its exponential for the draw (1 transcendental).
Bytes: each problem's read-haplotype probabilities (f32, R x H) and read
counts read once, and its trace written once (one byte per slot per step
and chain).  Moves ``loci_per_s``.
"""

from gpubench.metrics._work import add, least_seconds

UNIT = "%"
KERNELS = r"\b(?:calling|anchor)_kernel\b"


def problem_work(p, cell):
    """Work of one (locus, sample) problem over all its chains and steps."""
    P, R, H = cell["ploidy"], p["reads"], p["haplotypes"]
    runs = cell["chains"] * cell["steps"]
    flops = P * (R + H * (3 * R + 1))
    trans = P * H * (R + 1)
    return dict(flops=float(flops * runs), transcendentals=float(trans * runs),
                bytes=float(4 * R * (H + 1) + cell["chains"] * cell["steps"] * P))


def window_work(ctx):
    total = dict(flops=0.0, transcendentals=0.0, bytes=0.0)
    for j in ctx["jobs"]:
        if j["ok"]:
            for p in j["problems"]:
                total = add(total, problem_work(p, ctx["cell"]))
    return total


def read(ctx):
    seconds = ctx["kernel_seconds"](KERNELS)
    least = least_seconds(window_work(ctx), ctx["card"])
    if not seconds or least is None:
        return None
    return 100.0 * least / seconds
