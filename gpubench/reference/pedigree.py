"""Plain reference of MCHap's pedigree model (v0.11.1), in PyTorch.

What ``mchap call-pedigree`` samples: the joint posterior of every
sample's genotype (a multiset of ``ploidy`` haplotypes out of the
candidates) given each sample's reads and the pedigree,

    prod over samples s of  P(reads_s | g_s) x T[g_s | g_p(s), g_q(s)],

where T is MCHap's trio pmf (``mchap/pedigree/prior.py``, ``trio_log_pmf``)
over genotypes as multisets.  The Gibbs sampler's conditional adds, per
slot, log(1 + copies of the candidate among the other slots): that turns
the target over multisets into one over ordered slots, so the multisets
the chains visit follow the product above.

The trio pmf, for a child of ploidy P and gamete ploidies tau_p + tau_q = P:

- a parent's gamete at tau = P/2 and lambda 0 (no double reduction):
  tau draws without replacement from the parent's P copies, the pmf of
  its dosage prod_h C(d_parent[h], d_gamete[h]) / C(P, tau);
- the gamete of an unknown parent: tau independent draws from the prior
  frequencies (flat when none are given), a multinomial;
- each parent's gamete is its own with probability 1 - error and the
  unknown parent's with probability ``error``;
- T[child | p, q] sums, over the (gamete of p, gamete of q) pairs whose
  union is the child, the two mixed gametes' product.  Expanded, that is
  MCHap's four-branch mixture (both gametes true, either one in error,
  both in error).

A founder (no parents in the pedigree) takes the trio pmf with both
gametes of unknown parents: a multinomial of ``ploidy`` draws from the
prior frequencies.

For a family of two founders and their F1, given the parents' genotypes
the progeny are independent, so the parents' joint posterior is

    L_p(a) L_q(b) prior(a) prior(b) prod over children c of M_c(a, b),
    M_c(a, b) = sum over g of T[g | a, b] L_c(g),

exact at G^2 parent pairs and G^3 trio entries (G genotypes), and each
child's marginal follows from it.  PEDERR, which MCHap reports as the
share of a trace's states in which a child's genotype cannot be made of
a gamete of each parent's genotype, is here its posterior probability:
the mass of the child's (genotype, parents) states whose no-error trio
term is 0.  A founder's PEDERR is 0, as MCHap's is.  T is computed in
blocks of parent rows, so memory stays bounded at any panel size.

Departures from MCHap, each of which MCHap's own defaults make moot:

- MCHap computes annealing weights for the gamete error over the burn-in
  but never applies them (``pedigree/mcmc.py``); neither does this.
- Only lambda 0 and gamete ploidies of half the ploidy; only a family of
  two founders and their F1 (``f1_posteriors`` refuses any other).
- Every sample has the same ploidy.

``dtype`` float64 is the reference.  The precision control computes the
same with every tensor held in ``dtype`` (bfloat16): the genotype
log-likelihoods one term at a time (``model.log_likelihoods``), then the
gamete pmfs, the trio table and its sums as torch's ``dtype`` operations.
Imports only torch, the standard library and ``model.py``: nothing of the
program.
"""

import math

import torch

from gpubench.reference import model

F64 = model.F64
# the reference's sums are float32 or wider: no TF32 in a matrix product on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# trio-table entries held at once, in a block of parent rows (float64: 8
# bytes each; the gamete-pair products behind a block take a few times more)
BLOCK_ENTRIES = 1 << 21


def gamete_pmf(parents, gametes):
    """[G, K]: the pmf of each gamete dosage ``gametes`` [K, H] (tau copies)
    drawn without replacement from each parent dosage ``parents`` [G, H]."""
    tau, ploidy = int(gametes[0].sum()), int(parents[0].sum())
    comb = torch.tensor([[math.comb(n, k) for k in range(ploidy + 1)]
                         for n in range(ploidy + 1)], dtype=F64)  # 0 where k > n
    ways = comb[parents[:, None, :], gametes[None, :, :]].prod(dim=2)
    return ways / math.comb(ploidy, tau)


def multinomial_pmf(dosages, frequencies):
    """[K]: the pmf of each dosage [K, H] of independent draws from
    ``frequencies`` [H]."""
    d = dosages.to(F64)
    n = d.sum(dim=1)
    log_f = torch.log(frequencies.to(F64))
    terms = torch.where(d > 0, d * log_f, torch.zeros_like(d))
    return torch.exp(torch.lgamma(n + 1) - torch.lgamma(d + 1).sum(dim=1) + terms.sum(dim=1))


class Family:
    """The gamete pmfs, ε-mixed, of every parent genotype, and the map of
    gamete pairs to child genotypes, for ``n_haplotypes`` candidates at
    ``ploidy``; ``error`` is each gamete's error (MCHap's
    ``--gamete-error``) on the two parents' sides."""

    def __init__(self, n_haplotypes, ploidy, error=(0.01, 0.01), frequencies=None,
                 dtype=F64):
        if ploidy % 2:
            raise ValueError("gametes of half the ploidy need an even ploidy")
        self.ploidy, self.dtype = ploidy, dtype
        self.gens = model.genotypes(n_haplotypes, ploidy)  # [G, P]
        self.dosage = model.dosage(self.gens, n_haplotypes)  # [G, H]
        gametes = model.genotypes(n_haplotypes, ploidy // 2)
        gam_dose = model.dosage(gametes, n_haplotypes)  # [K, H]
        f = torch.as_tensor([1.0] * n_haplotypes if frequencies is None else frequencies,
                            dtype=F64)
        f = f / f.sum()
        self.founder_prior = multinomial_pmf(self.dosage, f).to(dtype)  # [G]
        true = gamete_pmf(self.dosage, gam_dose)  # [G, K]
        unknown = multinomial_pmf(gam_dose, f)  # [K]
        self.mixed = [((1 - e) * true + e * unknown[None]).to(dtype) for e in error]
        self.true = true.to(dtype)
        # child genotype of each (gamete of p, gamete of q) pair
        index = {tuple(d.tolist()): g for g, d in enumerate(self.dosage)}
        pair = gam_dose[:, None, :] + gam_dose[None, :, :]
        self.child = torch.tensor([index[tuple(d.tolist())] for d in pair.reshape(-1, n_haplotypes)])
        self._support = None

    @property
    def n_genotypes(self):
        return self.gens.shape[0]

    def blocks(self):
        """Slices of parent p's rows, each of at most ``BLOCK_ENTRIES``
        trio entries."""
        G = self.n_genotypes
        rows = max(1, BLOCK_ENTRIES // (G * G))
        return [slice(start, min(G, start + rows)) for start in range(0, G, rows)]

    def trio_blocks(self):
        """(rows of parent p, T [rows, G, G] over (p, q, child)) in blocks."""
        mixed_p, mixed_q = self.mixed
        for sl in self.blocks():
            yield sl, self._combine(mixed_p[sl], mixed_q)

    def _combine(self, gam_p, gam_q):
        """sum over gamete pairs whose union is the child: [rows, G, G]."""
        n, G = gam_p.shape[0], self.n_genotypes
        prod = (gam_p[:, None, :, None] * gam_q[None, :, None, :]).reshape(n, G, -1)
        out = torch.zeros(n, G, G, dtype=self.dtype)
        return out.index_add_(2, self.child, prod)

    def trio_table(self):
        """T [G, G, G]: the child's pmf given each (p, q) pair."""
        return torch.cat([t for _, t in self.trio_blocks()])

    def support(self):
        """bool [G, G, G]: whether the child's genotype can be made of a
        gamete of each parent's genotype (the no-error trio term is not 0)."""
        if self._support is None:
            self._support = torch.cat(
                [self._combine(self.true[sl], self.true) > 0 for sl in self.blocks()])
        return self._support


def f1_posteriors(family, llks, parents):
    """Each sample's exact marginal genotype posterior [S, G] and PEDERR
    [S] for two founders and their F1.

    ``llks`` [S, G]: ln P(reads_s | genotype) over ``family.gens``;
    ``parents`` [S] pairs of sample indices (-1: unknown).  The
    founders are the two samples without parents; every other sample has
    both of them as parents."""
    founders = [i for i, pq in enumerate(parents) if tuple(pq) == (-1, -1)]
    if len(founders) != 2 or any(
            sorted(pq) != founders for i, pq in enumerate(parents) if i not in founders):
        raise ValueError("the reference takes two founders and their F1 alone")
    p, q = founders
    children = [i for i in range(len(parents)) if i not in founders]
    dtype, G = family.dtype, family.n_genotypes
    llks = llks.to(dtype)
    lc = torch.exp(llks[children] - llks[children].max(dim=1, keepdim=True).values)  # [C, G]
    # the parents' joint posterior: [G, G] over (genotype of p, of q)
    m = torch.empty(G, G, len(children), dtype=dtype)  # M_c(a, b), over L_c scaled
    for sl, t in family.trio_blocks():
        m[sl] = torch.einsum("abg,cg->abc", t, lc)
    prior = torch.log(family.founder_prior)
    joint = (llks[p] + prior)[:, None] + (llks[q] + prior)[None, :] + torch.log(m).sum(dim=2)
    post = torch.exp(joint - torch.logsumexp(joint.to(F64), dim=(0, 1)).to(dtype)).to(dtype)
    marginals = torch.zeros(len(parents), G, dtype=dtype)
    marginals[p] = post.sum(dim=1)
    marginals[q] = post.sum(dim=0)
    # a child's states: sum over parent pairs of post(a, b) T[g | a, b] L_c(g) / M_c(a, b)
    w = post[:, :, None] / m  # [G, G, C]
    kid = torch.zeros(len(children), G, dtype=dtype)
    error = torch.zeros(len(children), G, dtype=dtype)
    support = family.support()
    for sl, t in family.trio_blocks():
        kid += torch.einsum("abc,abg->cg", w[sl], t)
        error += torch.einsum("abc,abg->cg", w[sl], torch.where(support[sl], 0, t))
    pederr = torch.zeros(len(parents), dtype=dtype)
    marginals[children] = (kid * lc).to(dtype)
    pederr[children] = (error * lc).sum(dim=1).to(dtype)
    return marginals, pederr
