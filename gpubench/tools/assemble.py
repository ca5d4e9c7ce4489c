"""The tool ``mchap assemble``: its tap, its reference and its judge.

The tap keeps, besides each problem's reads and sampled states, the
states its de novo trace kept (``kept``), tabulated by the judge after
the window.  The candidates of a sample-locus are the locus's founder
haplotypes (the data writer's truth) and the sample's own called
haplotypes; a sampler state is the haplotypes' alleles [ploidy, n_snv].
Besides the shared numbers (``reference/judge.py``), each call's ``GT``
(with its ``.`` alleles), ``GPM`` and ``SPM`` are held to the summary
that MCHap's rules give of the states the sampler kept (``tab_diff``,
exact).  That follows the program from its own trace, whose states the
log-likelihood check judges, so it holds however well the chains mix.
``unresolved`` counts calls with an allele below the reporting
threshold (``.``), which ``tab_diff`` judges and ``gap_max`` leaves out.
"""

import math

import numpy as np
import torch

from gpubench import taps
from gpubench.reference import judge as lib
from gpubench.reference import model, reads

SITE = ("mchap_tpu_torch.application.assemble", "fit_denovo_multi")
WORK = "k1_roofline"
# the MCMC steps and burn of the fault tests' small run on the CPU
SMALL_RUN = (400, 200)


def tap(seed, burn=0):
    """The block fit's record; each problem's trace keeps what follows
    the cell's ``burn`` steps."""
    def entry(problem, trace, rng):
        out = taps.problem_entry(problem, trace, rng)
        out["kept"] = taps.kept_states(trace, burn)  # tabulated by the judge, after the window
        return out

    return taps.tap(SITE, seed, entry)


class Reference(lib.Reference):
    POSTERIOR = "orderings"

    def read_loci(self, dataset):
        return reads.bed_loci(dataset["targets"], dataset["variants"])

    def candidates(self, locus, extra=()):
        founders = [reads.haplotype_alleles(locus, s)
                    for s in self.data["panels"][locus.name]["sequences"]]
        rows = list({tuple(h): None for h in list(founders) + list(extra)})
        return np.array(rows, np.int64).reshape(len(rows), len(locus.positions)), None

    def genotype(self, locus, state):
        n_alleles = torch.tensor([len(a) for a in locus.alleles])
        if state.shape != (self.ploidy, len(n_alleles)) or ((state < 0) | (state >= n_alleles)).any():
            return None  # not a genotype of this locus
        return state, torch.arange(self.ploidy)[None]


def judge(ref, answers, record, bad_summary=()):
    """Numbers of one job's answers and record summaries
    (``answers_from_vcf``) and sampler record (``tap``) against the
    reference, and the worst sample-locus behind each widest gap."""
    n, worst = lib.start(bad_summary)
    worst["llk_err_max"], tabs = lib.judge_sampler(ref, record, n)
    for locus in ref.loci:
        summaries, status = {}, {}
        if len(locus.positions):
            summaries = {s: lib.summary_of(tabs[(locus.name, s)]) for s in ref.samples
                         if (locus.name, s) in tabs}
            status = lib.reported(summaries.values(), ref.threshold)
        for s in ref.samples:
            a = answers.get((locus.name, s))
            got = lib.read_answer(ref, locus, s, a, n)
            if got is None:
                continue
            r, resolved, called = got
            if len(locus.positions):
                sm = summaries.get(s)
                mode = None if sm is None or sm["total"] != ref.kept else lib.match_summary(a, sm, status)
                if mode is None:
                    n["tab_diff"] += 1
                    worst["tab_diff"] = (locus.name, s, a["n_dot"], a["gpm"],
                                         None if sm is None else sm["total"])
                else:
                    called = mode.astype(np.int64)  # the call with its '.' alleles filled in
            lib.judge_genotype(ref, locus, s, a, r, resolved, called, n, worst)
    return n, worst


def problems(ref, cell):
    """Each (locus, sample) problem's inputs as the sampler's mathematics
    sees them, for the work counts of ``metrics/``: distinct reads, and
    the alleles of each SNV left free by the homozygosity screen."""
    out = []
    for locus in ref.loci:
        n_alleles = [len(a) for a in locus.alleles]
        for s in ref.samples:
            r = ref.sample_reads(locus, s)
            free = model.het_positions(r.dists, r.counts, n_alleles, ref.ploidy,
                                       cell["fix_homozygous"])
            out.append(dict(reads=len(r.counts),
                            free_alleles=[a for a, f in zip(n_alleles, free.tolist()) if f]))
    return out


def unchanged_samplers():
    """The samplers this tool's jobs run, as (module of the port, name,
    a version whose every step returns the chains' initial state), for
    the fault test of a state left unchanged: K1
    (``ops/cuda_denovo.denovo_sampler``), with that state's
    log-likelihood."""
    from mchap_tpu_torch.ops import cuda_denovo

    def k1_unchanged(real):
        def frozen(lr, counts, g_init, nall, pbreak, problem, *, n_steps, **kwargs):
            trace, _ = real(lr, counts, g_init, nall, pbreak, problem, n_steps=1, **kwargs)
            P = g_init.shape[0]
            base = cuda_denovo.next_pow2(max(lr.shape[2], 2))
            packed = sum(g_init[h].long() * base ** h for h in range(P))  # [NB, C]
            prob = problem.long()
            # lr [S, NB, A, R]: each haplotype's read log-probability, summed over sites
            per_site = torch.stack([
                torch.gather(lr[prob], 2, g_init[h].long().T[:, :, None, None]
                             .expand(-1, -1, 1, lr.shape[3]))[:, :, 0] for h in range(P)])
            hap = per_site.sum(dim=2)  # [P, C, R]
            llk = ((torch.logsumexp(hap, dim=0) - math.log(P)) * counts[prob]).sum(dim=1)
            return (packed.to(trace.dtype)[None].repeat(n_steps, 1, 1),
                    llk.to(torch.float32)[None].repeat(n_steps, 1))
        return frozen

    return [("models.assemble", "denovo_sampler", k1_unchanged)]
