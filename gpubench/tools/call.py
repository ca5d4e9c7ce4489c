"""The tool ``mchap call``: its tap, its reference and its judge.

The candidates of a sample-locus are the panel's haplotypes (those the
prior leaves in), so the reference posterior is exact; a sampler state
is the genotype's indices into them [ploidy].  Besides the shared
numbers (``reference/judge.py``), the called genotype's ``GPM`` is held
to its exact posterior probability over the candidates
(``gpm_err_max``).  ``records_bad`` also counts records whose alleles
are not the panel's, and calls with a ``.`` allele among them.
"""

import math

import torch

from gpubench import taps
from gpubench.reference import judge as lib
from gpubench.reference import reads

SITE = ("mchap_tpu_torch.application.call", "fit_calling_multi")
WORK = "k2_roofline"
# the MCMC steps and burn of the fault tests' small run on the CPU
SMALL_RUN = (1000, 500)


def tap(seed, burn=0):
    """The block fit's record (``burn``: the calling trace keeps only
    what follows it already)."""
    return taps.tap(SITE, seed)


class Reference(lib.Reference):
    POSTERIOR = "genotypes"

    def read_loci(self, dataset):
        self.panel = {p["locus"].name: p for p in reads.panel_loci(dataset["panel"])}
        return [p["locus"] for p in self.panel.values()]

    def candidates(self, locus, extra=()):
        p = self.panel[locus.name]
        haps, freqs = p["haplotypes"], p["frequencies"]
        if self.inbreeding and freqs is not None:
            keep = freqs > 0  # the program masks zero-frequency haplotypes
            return haps[keep], freqs[keep] / freqs[keep].sum()
        return haps, None

    def genotype(self, locus, state):
        haps = torch.as_tensor(self.candidates(locus)[0], dtype=torch.long)
        if state.shape != (self.ploidy,) or ((state < 0) | (state >= len(haps))).any():
            return None
        return haps, torch.sort(state).values[None]

    def fits(self, locus, seqs, gt):
        # the panel's alleles, every one called
        return seqs == self.panel[locus.name]["sequences"] and None not in gt

    def sampler_state(self, called, genotype):
        return genotype


def judge(ref, answers, record, bad_summary=()):
    """Numbers of one job's answers and record summaries
    (``answers_from_vcf``) and sampler record (``tap``) against the
    reference, and the worst sample-locus behind each widest gap."""
    n, worst = lib.start(bad_summary)
    worst["llk_err_max"], _ = lib.judge_sampler(ref, record, n)
    for locus in ref.loci:
        for s in ref.samples:
            a = answers.get((locus.name, s))
            got = lib.read_answer(ref, locus, s, a, n)
            if got is not None:
                lib.judge_genotype(ref, locus, s, a, *got, n, worst)
    return n, worst


def problems(ref, cell):
    """Each (locus, sample) problem's inputs as the sampler's mathematics
    sees them, for the work counts of ``metrics/``: distinct reads, and
    the haplotypes the sampler chooses among."""
    out = []
    for locus in ref.loci:
        haps = ref.candidates(locus)[0]
        for s in ref.samples:
            out.append(dict(reads=len(ref.sample_reads(locus, s).counts), haplotypes=len(haps)))
    return out


def unchanged_samplers():
    """The samplers this tool's jobs run, as (module of the port, name,
    a version whose every step returns the chains' initial state), for
    the fault test of a state left unchanged: K2
    (``ops/cuda_calling.calling_sampler``, which starts every slot at the
    panel's first haplotype) and the torch calling route
    (``ops/calling_mcmc.calling_sampler``), each a job runs one of."""
    def k2_unchanged(real):
        def frozen(rh, counts, n_valid, problem, *, n_steps, ploidy, **kwargs):
            alleles, _ = real(rh, counts, n_valid, problem, n_steps=1, ploidy=ploidy, **kwargs)
            prob = problem.long()
            llk = (rh[prob][:, :, 0] * counts[prob]).sum(dim=1)  # every slot on haplotype 0
            return (torch.zeros_like(alleles).repeat(n_steps, 1, 1),
                    llk.to(torch.float32)[None].repeat(n_steps, 1))
        return frozen

    def route_unchanged(real):
        def frozen(seed, row_offset, initial, read_hap, read_counts, *, n_steps, **kwargs):
            S, C, P = initial.shape
            rows = torch.arange(S, device=read_hap.device)[:, None, None]
            rh = read_hap[rows, :, initial.long()]  # [S, C, P, R]
            llk = ((torch.logsumexp(rh, dim=2) - math.log(P)) * read_counts[:, None, :]).sum(-1)
            return (initial[:, :, None, :].repeat(1, 1, n_steps, 1).long(),
                    llk[:, :, None].repeat(1, 1, n_steps))
        return frozen

    return [("models.calling", "calling_sampler", k2_unchanged),
            ("ops.calling_mcmc", "calling_sampler", route_unchanged)]
