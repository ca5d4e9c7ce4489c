"""``k3_roofline``: K3's share of its roofline, in %.

Layer: K3, the pedigree sampler kernel (``ops/cuda_pedigree.py`` +
``csrc/pedigree_sampler.cu``).  The least time of the work that the
window's pedigree sampling needs, over the device time of K3's kernel in
the profiler's trace.

The work is counted from MCHap's pedigree sampler (v0.11.1,
``pedigree/mcmc``, Gibbs steps with parental allele swaps), at each
locus's real inputs (``tools/call-pedigree.py``'s ``problems``), not from
K3's source.  A step of a (locus, chain) visits each sample's P slots in
turn; at each slot:

- the other slots' read probabilities are summed once per distinct read
  of the sample (the slot's own taken out: 1 add per read), and each of
  the H candidate haplotypes is scored over the R distinct reads (its
  read probability added, 1 add; the log, 1 transcendental; weighted in,
  1 multiply-add: 3 flops), as in ``k2_roofline``;
- each candidate's prior: the trio term of the sample (if it has
  parents) and of each of its children, each the four-branch mixture of
  MCHap's trio pmf over one split of the child's dosage (a child has at
  least one; more depend on the genotypes, so the count is a lower
  bound): 4 branches x (2 multiplies + 1 add), and 1 add into the
  candidate's score, 13 flops, and its log (1 transcendental); then the
  slot-ordering term (1 add) and the candidate's exponential for the
  draw (1 transcendental).

Then each parental pair's Metropolis-Hastings swap: both parents' read
probabilities with the swapped slot replaced (per read 2 adds, the log,
1 multiply-add: 4 flops and 1 transcendental), the trio term of each
member of the pair's blanket (the pair and their children: 13 flops and
a log each) and the acceptance's exponential.  Bytes: each locus's
read-haplotype probabilities (f32, R x H per sample) and read counts
read once, and its trace written once (one byte per slot per step and
chain).  Moves ``loci_per_s``.
"""

from gpubench.metrics._work import add, least_seconds

UNIT = "%"
KERNELS = r"\bpedigree_kernel\b"
TRIO_FLOPS = 13


def problem_work(p, cell):
    """Work of one locus over all its chains and steps: ``p["reads"]``
    each sample's distinct reads, ``p["haplotypes"]`` H, ``p["parents"]``
    each sample's two parents (-1: unknown)."""
    P, H, reads, parents = cell["ploidy"], p["haplotypes"], p["reads"], p["parents"]
    children = [sum(i in pq for pq in parents) for i in range(len(reads))]
    flops = trans = 0
    for s, R in enumerate(reads):
        trios = (max(parents[s]) >= 0) + children[s]
        flops += P * (R + H * (3 * R + 1 + trios * TRIO_FLOPS))
        trans += P * H * (R + 1 + trios)
    pairs = {tuple(sorted(pq)) for pq in parents if min(pq) >= 0 and pq[0] != pq[1]}
    for pair in pairs:
        blanket = set(pair) | {i for i, pq in enumerate(parents) if set(pq) & set(pair)}
        flops += sum(4 * reads[x] for x in pair) + TRIO_FLOPS * len(blanket)
        trans += sum(reads[x] for x in pair) + len(blanket) + 1
    runs = cell["chains"] * cell["steps"]
    out_bytes = runs * P * len(reads)
    return dict(flops=float(flops * runs), transcendentals=float(trans * runs),
                bytes=float(4 * sum(reads) * (H + 1) + out_bytes))


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
