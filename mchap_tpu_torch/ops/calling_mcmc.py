"""Batched Gibbs / Metropolis-Hastings sampler over allele-index genotypes.

Port of ``mchap_tpu/ops/calling_mcmc.py`` (reference
``mchap/calling/mcmc.py``) in plain PyTorch, batched over problems and
chains.  The read x haplotype log-likelihood matrix is computed once per
problem; scoring every allele option of a slot is then one logaddexp
over [R, H] and a weighted sum over reads.

This is the sampler for ``--use-dirmul-prior`` and for
``CallingMCMC(step_type="Metropolis-Hastings")``.  Flat-prior Gibbs runs
through K2 (``ops/cuda_calling.py``) instead.  A step's draws come from
one ``utils.philox.keyed_uniforms`` call, keyed by the seed and each
chain's index in the whole block (``step_draw_offsets``), so how a block
is split over devices and processes changes no draw; a candidate's llk is
an elementwise product and a sum over reads, not a batched matmul, whose
sums on a card depend on its batch size.  The stream differs from JAX's,
so results are held to the same posteriors, not the same draws.

Shapes: read_hap f64[S, R, H], read_counts [S, R], inbreeding [S],
frequencies [S, H] or None, n_valid [S] or None (columns >= n_valid[s]
of problem s are cross-locus padding and are never drawn).
"""

import math

import torch

from mchap_tpu_torch.ops.priors import (
    log_genotype_allele_flat_prior,
    log_genotype_allele_prior,
    log_genotype_prior,
)
from mchap_tpu_torch.utils.philox import keyed_uniforms

_NEG = -1e300  # effectively -inf in f64 logits without nan-propagation risk


def _valid_columns(n_valid, n_alleles, device):
    """[B, H] bool of real (non-padding) allele columns, or None."""
    if n_valid is None:
        return None
    return torch.arange(n_alleles, device=device)[None, :] < n_valid[:, None]


def _option_llks(read_hap, read_counts, genotype, slot, log_ploidy):
    """llk of every allele option for one slot of each chain: [B, H].

    read_hap [B, R, H], read_counts [B, R], genotype [B, P], slot [B].
    """
    B, R, _ = read_hap.shape
    ploidy = genotype.shape[1]
    sub = torch.gather(read_hap, 2, genotype[:, None, :].expand(B, R, ploidy))
    keep = torch.arange(ploidy, device=slot.device)[None, :] != slot[:, None]
    rest = torch.logsumexp(torch.where(keep[:, None, :], sub, _NEG), dim=-1)
    read_log = torch.logaddexp(rest[..., None], read_hap) - log_ploidy
    return (read_counts[:, :, None] * read_log).sum(1)


def _option_genotypes(genotype, slot, n_alleles):
    """All option genotypes [B, H, P]: ``slot`` replaced by each allele."""
    B, ploidy = genotype.shape
    options = genotype[:, None, :].expand(B, n_alleles, ploidy).clone()
    alleles = torch.arange(n_alleles, device=genotype.device)
    options.scatter_(
        2, slot[:, None, None].expand(B, n_alleles, 1),
        alleles[None, :, None].expand(B, n_alleles, 1),
    )
    return options


def _gibbs_slot(u, genotype, slot, read_hap, read_counts, log_ploidy,
                prior_kind, inbreeding, frequencies, valid):
    n_alleles = read_hap.shape[-1]
    llks = _option_llks(read_hap, read_counts, genotype, slot, log_ploidy)
    options = _option_genotypes(genotype, slot, n_alleles)
    if prior_kind == 0:
        lpriors = log_genotype_allele_flat_prior(options, slot[:, None])
    else:
        lpriors = log_genotype_allele_prior(
            options, slot[:, None], n_alleles, inbreeding=inbreeding[:, None],
            frequencies=frequencies[:, None, :],
        )
    logits = llks + lpriors
    if valid is not None:
        logits = torch.where(valid, logits, _NEG)
    # categorical draw by Gumbel-max; u [B, H]
    choice = torch.argmax(logits - torch.log(-torch.log(u)), dim=1)
    genotype = genotype.scatter(1, slot[:, None], choice[:, None])
    return genotype, llks.gather(1, choice[:, None])[:, 0]


def _mh_slot(u, genotype, slot, read_hap, read_counts, log_ploidy,
             prior_kind, inbreeding, frequencies, valid):
    """Metropolis-Hastings slot update, ``u`` [B, 1] its draw; reference
    calling/mcmc.py:15-140."""
    B, ploidy = genotype.shape
    n_alleles = read_hap.shape[-1]
    llks = _option_llks(read_hap, read_counts, genotype, slot, log_ploidy)
    if prior_kind == 0:
        lpriors = torch.zeros_like(llks)
    else:
        options = _option_genotypes(genotype, slot, n_alleles)
        lpriors = log_genotype_prior(
            options, n_alleles, inbreeding=inbreeding[:, None],
            frequencies=frequencies[:, None, :],
        ).to(llks.dtype)
    current = genotype.gather(1, slot[:, None])  # [B, 1]
    llk = llks.gather(1, current)
    lprior = lpriors.gather(1, current)
    # proposal ratio: copies of option allele in proposed / copies of
    # current allele in current genotype (calling/mcmc.py:123-127)
    others = torch.arange(ploidy, device=slot.device)[None, :] != slot[:, None]
    alleles = torch.arange(n_alleles, device=slot.device)
    counts_other = (
        others[:, None, :] & (genotype[:, None, :] == alleles[None, :, None])
    ).sum(dim=-1)  # [B, H] copies among constant slots
    copies_proposed = (counts_other + 1).to(llks.dtype)
    copies_current = (counts_other.gather(1, current) + 1).to(llks.dtype)
    lproposal = torch.log(copies_proposed) - torch.log(copies_current)
    mh_ratio = (llks - llk) + (lpriors - lprior) + lproposal
    accept = torch.exp(torch.clamp(mh_ratio, max=0.0))
    if valid is None:
        n_proposals = torch.full((B, 1), n_alleles - 1.0, dtype=llks.dtype,
                                 device=llks.device)
    else:
        # padding alleles are never proposed; uniform over the valid rest
        accept = torch.where(valid, accept, 0.0)
        n_proposals = (valid.sum(dim=1, keepdim=True) - 1).to(llks.dtype)
    probs = accept.scatter(1, current, 0.0) / n_proposals
    probs = probs.scatter(1, current, 1.0 - probs.sum(dim=1, keepdim=True))
    # inverse-CDF draw matching reference random_choice semantics
    cdf = torch.cumsum(probs, dim=1)
    choice = (cdf <= u * cdf[:, -1:]).sum(dim=1)
    genotype = genotype.scatter(1, slot[:, None], choice[:, None])
    return genotype, llks.gather(1, choice[:, None])[:, 0]


def step_draw_offsets(ploidy, n_alleles, step_type):
    """Offsets of a chain's draws in one step and their count ``D``: the
    slot order's ``ploidy`` draws at 0, then each visited slot's, H for a
    Gibbs slot, 1 for a Metropolis-Hastings slot, in visiting order."""
    per_slot = n_alleles if step_type == 0 else 1
    return dict(slots=ploidy, per_slot=per_slot, D=ploidy * (1 + per_slot))


def calling_sampler(seed, row_offset, initial, read_hap, read_counts, *, n_steps,
                    step_type=0, prior_kind=0, inbreeding=0.0,
                    frequencies=None, n_valid=None):
    """Run batched-chain MCMC over allele-index genotypes.

    seed : the draws' seed; row_offset : the global index of this call's
        first chain in the whole block.  Chain b (ordered (problem,
        chain)) draws ``keyed_uniforms`` row row_offset + b, in the
        layout of ``step_draw_offsets``
    initial : int[S, n_chains, ploidy]
    read_hap : f64[S, R, H]; read_counts : [S, R]
    step_type : 0 = Gibbs, 1 = Metropolis-Hastings
    prior_kind : 0 = flat (no prior supplied), 1 = DM/frequency
    inbreeding : number or [S]; frequencies : [S, H] or None
    n_valid : [S] or None

    Each step visits the slots in a fresh random order, sorts the
    genotype, and records it with the llk of the last slot's choice
    (reference calling/mcmc.py:232-390).  Returns genotypes
    int64[S, n_chains, n_steps, ploidy] and llks f64[S, n_chains, n_steps].
    """
    S, n_chains, ploidy = initial.shape
    device = read_hap.device
    n_alleles = read_hap.shape[-1]
    B = S * n_chains
    problem = torch.arange(S, device=device).repeat_interleave(n_chains)
    rh = read_hap[problem]
    counts = torch.as_tensor(read_counts, dtype=rh.dtype, device=device)[problem]
    inbreeding = torch.as_tensor(inbreeding, dtype=torch.float64, device=device)
    inbreeding = inbreeding.expand(S)[problem]
    if frequencies is None:
        frequencies = torch.zeros((S, n_alleles), dtype=torch.float64, device=device)
    frequencies = torch.as_tensor(frequencies, dtype=torch.float64, device=device)
    frequencies = frequencies[problem]
    valid = None
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid, device=device).expand(S)
        valid = _valid_columns(n_valid[problem], n_alleles, device)
    log_ploidy = math.log(ploidy)
    slot_fn = _gibbs_slot if step_type == 0 else _mh_slot
    lay = step_draw_offsets(ploidy, n_alleles, step_type)
    rows = row_offset + torch.arange(B, device=device)

    g = initial.reshape(B, ploidy).long().to(device)
    genotypes = torch.empty((n_steps, B, ploidy), dtype=torch.long, device=device)
    llks = torch.empty((n_steps, B), dtype=rh.dtype, device=device)
    for step in range(n_steps):
        u = keyed_uniforms(seed, rows, step, lay["D"], torch.float64)
        order = torch.argsort(u[:, :ploidy], dim=1)
        w = lay["per_slot"]
        for t in range(ploidy):
            start = lay["slots"] + t * w
            g, llk = slot_fn(
                u[:, start:start + w], g, order[:, t], rh, counts, log_ploidy,
                prior_kind, inbreeding, frequencies, valid,
            )
        g = torch.sort(g, dim=1).values
        genotypes[step] = g
        llks[step] = llk
    genotypes = genotypes.reshape(n_steps, S, n_chains, ploidy).permute(1, 2, 0, 3)
    llks = llks.reshape(n_steps, S, n_chains).permute(1, 2, 0)
    return genotypes, llks


def greedy_caller(read_hap, read_counts, *, ploidy, prior_kind=0,
                  inbreeding=0.0, frequencies=None, n_valid=None):
    """Greedy initial genotype of each problem: [S, ploidy], sorted.

    Adds the best allele one slot at a time; partial genotypes of length
    k are scored with a k-haplotype likelihood (mean over k) plus the
    full genotype prior of the partial genotype.  Reference:
    calling/mcmc.py:393-453.
    """
    S, R, n_alleles = read_hap.shape
    device = read_hap.device
    counts = torch.as_tensor(read_counts, dtype=read_hap.dtype, device=device)
    inbreeding = torch.as_tensor(inbreeding, dtype=torch.float64, device=device)
    inbreeding = inbreeding.expand(S)
    if frequencies is None:
        frequencies = torch.zeros((S, n_alleles), dtype=torch.float64, device=device)
    frequencies = torch.as_tensor(frequencies, dtype=torch.float64, device=device)
    valid = None
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid, device=device).expand(S)
        valid = _valid_columns(n_valid, n_alleles, device)
    alleles = torch.arange(n_alleles, device=device)
    genotype = torch.zeros((S, 0), dtype=torch.long, device=device)
    for i in range(ploidy):
        k = i + 1
        options = torch.cat(
            [
                genotype[:, None, :].expand(S, n_alleles, i),
                alleles[None, :, None].expand(S, n_alleles, 1),
            ],
            dim=-1,
        )  # [S, H, k]
        sub = torch.gather(
            read_hap, 2, options.reshape(S, 1, n_alleles * k).expand(S, R, -1)
        ).reshape(S, R, n_alleles, k)
        read_log = torch.logsumexp(sub, dim=-1) - math.log(k)
        llks = torch.einsum("sr,srh->sh", counts, read_log)
        if prior_kind == 0:
            scores = llks
        else:
            scores = llks + log_genotype_prior(
                options, n_alleles, inbreeding=inbreeding[:, None],
                frequencies=frequencies[:, None, :],
            )
        if valid is not None:
            scores = torch.where(valid, scores, _NEG)
        best = torch.argmax(scores, dim=1)
        genotype = torch.cat([genotype, best[:, None]], dim=1)
    return torch.sort(genotype, dim=1).values
