"""Plain reference of MCHap's genotype model (v0.11.1), in PyTorch.

For one sample at one locus: the log-likelihood of each genotype (a
multiset of ``ploidy`` haplotypes out of a set of candidate haplotypes)
given the sample's de-duplicated reads, its prior (flat: the genotype's
equivalent orderings; or MCHap's Dirichlet-multinomial over prior
frequencies with inbreeding F), and the exact posterior over the
candidates.  No MCMC: every candidate genotype is enumerated.

``dtype`` is float64 for the reference.  The precision control computes
the same in bfloat16, every reduction accumulated one term at a time and
rounded at each step, as a bfloat16 program would.  Imports only torch
and the standard library: nothing of the program.
"""

import functools
import itertools
import math

import torch

F64 = torch.float64


@functools.lru_cache(maxsize=64)
def genotypes(n_haplotypes, ploidy):
    """All multisets of ``ploidy`` haplotype indices, sorted: [G, ploidy]."""
    combos = list(itertools.combinations_with_replacement(range(n_haplotypes), ploidy))
    return torch.tensor(combos, dtype=torch.long).reshape(len(combos), ploidy)


def _sum(x, dim, dtype):
    """Sum over ``dim``; in bfloat16 one term at a time, rounded each step."""
    if dtype == F64:
        return x.sum(dim=dim)
    x = x.movedim(dim, 0)
    acc = torch.zeros_like(x[0])
    for term in x:
        acc = (acc + term).to(dtype)
    return acc


def _logsumexp(x, dim, dtype):
    m = x.max(dim=dim, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (torch.log(_sum(torch.exp(x - m), dim, dtype)) + m.squeeze(dim)).to(dtype)


def dosage(gens, n_haplotypes):
    """[G, H] copies of each haplotype in each genotype."""
    return torch.nn.functional.one_hot(gens, n_haplotypes).sum(dim=1)


def log_likelihoods(dists, counts, haplotypes, gens, dtype=F64):
    """ln P(reads | genotype) for every genotype of ``gens`` [G, P].

    ``dists`` f64[R, n_snv, A] (nan: no call), ``counts`` f64[R],
    ``haplotypes`` long[H, n_snv].  P(read | genotype) is the mean over
    the genotype's haplotypes of the product over called SNVs of the
    read's probability of the haplotype's allele."""
    R, n_snv, _ = dists.shape
    H, P = haplotypes.shape[0], gens.shape[1]
    if R == 0:
        return torch.zeros(gens.shape[0], dtype=dtype, device=gens.device)
    logq = torch.log(torch.nan_to_num(dists, nan=1.0)).to(dtype)  # [R, n_snv, A]
    idx = haplotypes.T.unsqueeze(0).expand(R, n_snv, H)
    per_snv = torch.gather(logq, 2, idx)  # [R, n_snv, H]
    hap_ll = _sum(per_snv, 1, dtype)  # [R, H]
    read_ll = _logsumexp(hap_ll[:, gens], 2, dtype) - math.log(P)
    weighted = (read_ll.to(dtype) * counts.to(dtype)[:, None]).to(dtype)  # [R, G]
    return _sum(weighted, 0, dtype)


def log_prior(gens, n_haplotypes, frequencies=None, inbreeding=0.0, dtype=F64, flat="orderings"):
    """ln prior of each genotype, up to a constant shared by all of them.

    Without inbreeding, flat over the haplotypes' orderings, ln(P! / prod
    dosage!) (``assemble``'s null prior, ``assemble/prior.py``), or, with
    ``flat="genotypes"``, flat over the genotypes themselves (``call``
    without a prior: its Gibbs conditional ``log_genotype_allele_flat_prior``
    weighs an allele by its copies, which cancels the orderings).
    Otherwise MCHap's Dirichlet-multinomial with alpha_i = f_i (1 - F) / F
    over the candidates' ``frequencies`` (uniform if None)."""
    d = dosage(gens, n_haplotypes).to(F64)
    P = gens.shape[1]
    f64 = dict(dtype=F64, device=gens.device)
    if not inbreeding and flat == "genotypes":
        return torch.zeros(gens.shape[0], dtype=dtype, device=gens.device)
    if not inbreeding:
        out = math.lgamma(P + 1.0) - torch.lgamma(d + 1.0).sum(dim=1)
        return out.to(dtype)
    f = (torch.full((n_haplotypes,), 1.0 / n_haplotypes, **f64) if frequencies is None
         else torch.as_tensor(frequencies, **f64))
    alpha = f * (1.0 - inbreeding) / inbreeding
    left = math.lgamma(P + 1.0) + torch.lgamma(alpha.sum()) - torch.lgamma(P + alpha.sum())
    terms = torch.lgamma(d + alpha) - torch.lgamma(d + 1.0) - torch.lgamma(alpha)
    return (left + terms.sum(dim=1)).to(dtype)


def posterior(dists, counts, haplotypes, ploidy, frequencies=None, inbreeding=0.0, dtype=F64,
              device="cpu", flat="orderings"):
    """(genotypes [G, P], ln posterior weight [G] up to a constant,
    posterior probabilities [G]) over every genotype of the candidate
    ``haplotypes``, computed on ``device``; returned on the CPU."""
    haplotypes = torch.as_tensor(haplotypes, dtype=torch.long, device=device)
    gens = genotypes(haplotypes.shape[0], ploidy).to(device)
    lp = (log_likelihoods(torch.as_tensor(dists, dtype=F64, device=device),
                          torch.as_tensor(counts, dtype=F64, device=device),
                          haplotypes, gens, dtype)
          + log_prior(gens, haplotypes.shape[0], frequencies, inbreeding, dtype, flat)).to(dtype)
    probs = torch.exp(lp - _logsumexp(lp, 0, dtype)).to(dtype)
    return gens.cpu(), lp.cpu(), probs.cpu()


def het_positions(dists, counts, n_alleles, ploidy, fix_homozygous=0.999):
    """MCHap's homozygosity screen before de novo sampling: at each SNV on
    its own, the flat-prior posterior over the SNV's genotypes given the
    reads there; an SNV where some allele is homozygous with probability
    ``fix_homozygous`` or more is fixed and never sampled.  Returns a
    bool [n_snv], True where the SNV stays free (heterozygous)."""
    dists = torch.as_tensor(dists, dtype=F64)
    counts = torch.as_tensor(counts, dtype=F64)
    n_alleles = torch.as_tensor(n_alleles)
    out = torch.zeros(len(n_alleles), dtype=torch.bool)
    for a in sorted(set(n_alleles.tolist()) - {0, 1}):
        js = (n_alleles == a).nonzero()[:, 0]
        gens = genotypes(a, ploidy)
        q = torch.nan_to_num(dists[:, js, :a], nan=1.0)  # a read with no call weighs 1
        ll = (torch.log(q[:, :, gens].mean(dim=3)) * counts[:, None, None]).sum(dim=0)
        probs = torch.softmax(ll + log_prior(gens, a), dim=1)  # [J, G]
        hom = (gens == gens[:, :1]).all(dim=1)
        out[js] = ~(probs[:, hom] >= fix_homozygous).any(dim=1)
    return out
