"""Exact genotype enumeration (PyTorch, f64): the ``call-exact`` compute
core and the oracle that gates every sampler.

Port of ``mchap_tpu/ops/exact.py`` (reference ``mchap/calling/exact.py``).
P(read | genotype) = (1/ploidy) * sum_k dosage[g, k] * P(read | hap k),
so every VCF-ordered genotype is scored with one [R, K] x [K, G] matmul,
on the device of its inputs.
"""

import numpy as np
import torch

from mchap_tpu_torch.numerics.combinadics import (
    count_unique_genotypes,
    enumerate_genotypes,
)
from mchap_tpu_torch.ops.likelihood import MIN_LOG, prepare_reads, read_hap_loglik
from mchap_tpu_torch.ops.priors import log_genotype_prior
from mchap_tpu_torch.utils.device import memory_budget, resolve_device

_F64 = torch.float64


def genotype_dosage_table(n_alleles: int, ploidy: int) -> np.ndarray:
    """Dense [G, K] dosage matrix of the VCF-ordered genotype table."""
    table = enumerate_genotypes(n_alleles, ploidy)  # [G, ploidy]
    dosage = np.zeros((table.shape[0], n_alleles), np.int32)
    rows = np.repeat(np.arange(table.shape[0]), ploidy)
    np.add.at(dosage, (rows, table.ravel()), 1)
    return dosage


def _table(array, like, dtype=None):
    return torch.tensor(array, dtype=dtype, device=like.device)


def genotype_likelihoods_from_read_hap(read_hap, ploidy, read_counts=None):
    """llk of every VCF-ordered genotype from the [.., R, K] read-hap matrix.

    Reference ``_genotype_likelihoods`` (calling/exact.py:252-263),
    evaluated as one dosage matmul with a per-read scale for stability.
    """
    n_alleles = read_hap.shape[-1]
    dosage = _table(genotype_dosage_table(n_alleles, ploidy), read_hap, read_hap.dtype)
    floor = -1e300 if read_hap.dtype == _F64 else -1e30
    m = torch.clamp(read_hap.max(dim=-1).values, min=floor)  # [.., R]
    e = torch.exp(read_hap - m[..., None])
    probs = torch.einsum("...rk,gk->...rg", e, dosage)
    read_log = torch.log(probs) + m[..., None] - np.log(ploidy)
    if read_counts is not None:
        counts = torch.as_tensor(
            np.asarray(read_counts) if not torch.is_tensor(read_counts) else read_counts,
            dtype=read_hap.dtype, device=read_hap.device,
        )
        read_log = read_log * counts[..., None]
    return read_log.sum(dim=-2)  # [.., G]


def genotype_likelihoods(reads, ploidy, haplotypes, read_counts=None,
                         dtype=torch.float64, device=None):
    """llk of every possible genotype; reference calling/exact.py:266-292."""
    log_reads = prepare_reads(reads, dtype, device)
    read_hap = read_hap_loglik(log_reads, haplotypes)
    return genotype_likelihoods_from_read_hap(read_hap, ploidy, read_counts)


def genotype_posteriors(log_likelihoods, ploidy=None, n_alleles=None, prior=None):
    """Posterior over all genotypes; reference calling/exact.py:295-329.

    ``prior``: optional (inbreeding, frequencies-or-None) tuple as in the
    reference (``ploidy`` and ``n_alleles`` are needed only with it).
    """
    llks = torch.as_tensor(log_likelihoods)
    if prior is not None:
        table = _table(enumerate_genotypes(n_alleles, ploidy), llks)
        frequencies = None if prior[1] is None else np.asarray(prior[1], float)
        lpriors = log_genotype_prior(
            table, n_alleles, inbreeding=prior[0], frequencies=frequencies
        )
        llks = llks + lpriors.to(llks.dtype)
    return torch.exp(llks - torch.logsumexp(llks, dim=-1, keepdim=True))


def posterior_allele_frequencies(posteriors, ploidy, n_alleles):
    """Posterior mean allele freqs / counts / occurrence probabilities.

    Reference calling/exact.py:332-369.  Returns (freqs, counts, occur).
    """
    p = torch.as_tensor(posteriors)
    dosage = _table(genotype_dosage_table(n_alleles, ploidy), p, p.dtype)  # [G, K]
    counts = torch.einsum("...g,gk->...k", p, dosage)
    occur = torch.einsum("...g,gk->...k", p, (dosage > 0).to(p.dtype))
    return counts / ploidy, counts, occur


def mode_genotype(posteriors, ploidy, n_alleles):
    """Posterior-mode genotype alleles + its probability + support probability.

    Support probability = summed posterior of all genotypes containing
    exactly the mode's allele set at any dosage (reference
    ``_genotype_support_log_joint``, calling/exact.py:64-105, and
    ``alternate_dosage_posteriors``, :372-407).

    Returns (alleles int[..., ploidy], mode_prob, support_prob, mode_index).
    """
    p = torch.as_tensor(posteriors)
    table = _table(enumerate_genotypes(n_alleles, ploidy), p, torch.long)
    occupancy = _table(genotype_dosage_table(n_alleles, ploidy) > 0, p)  # [G, K]
    idx = torch.argmax(p, dim=-1)
    alleles = table[idx]
    mode_prob = torch.gather(p, -1, idx[..., None])[..., 0]
    same_support = torch.all(occupancy == occupancy[idx][..., None, :], dim=-1)
    support_prob = torch.where(same_support, p, 0.0).sum(dim=-1)
    return alleles, mode_prob, support_prob, idx


def alternate_dosage_posteriors(genotype_alleles, probabilities):
    """Host-side: probabilities of all dosage-alternatives of a genotype.

    Reference calling/exact.py:372-407.  Returns (genotypes [N, ploidy],
    probs [N]) ordered by genotype index.
    """
    genotype_alleles = np.asarray(genotype_alleles)
    probabilities = np.asarray(probabilities)
    ploidy = len(genotype_alleles)
    support = np.unique(genotype_alleles)
    n_alleles_panel = _n_from_g(len(probabilities), ploidy)
    table = enumerate_genotypes(n_alleles_panel, ploidy)
    occupancy = genotype_dosage_table(n_alleles_panel, ploidy) > 0
    target = np.zeros(n_alleles_panel, bool)
    target[support] = True
    indices = np.flatnonzero(np.all(occupancy == target, axis=-1))
    return table[indices], probabilities[indices]


def _n_from_g(n_genotypes: int, ploidy: int) -> int:
    """Invert G = C(n + ploidy - 1, ploidy) for the panel size n."""
    n = 1
    while count_unique_genotypes(n, ploidy) < n_genotypes:
        n += 1
    if count_unique_genotypes(n, ploidy) != n_genotypes:
        raise ValueError("invalid number of genotypes for ploidy")
    return n


def _exact_stats_batch(read_hap, counts, n_valid, inbreeding, frequencies,
                       *, ploidy, use_prior):
    """Batched exact posterior statistics over a padded panel.

    ``read_hap``: f[B, R, H_pad] (padded haplotype columns MIN_LOG,
    padded reads all-zero rows with count 0); ``n_valid``: i[B] true
    panel sizes.  Genotypes drawing any allele >= n_valid[b] occupy a
    contiguous SUFFIX of the VCF-ordered genotype table (the table over
    the first H alleles is a prefix of the table over H' > H), so they
    are masked to -inf before normalisation — the valid prefix is then
    numerically the problem's own exact posterior.

    Returns (alleles [B, ploidy], mode_prob [B], support_prob [B],
    freqs [B, H_pad], occur [B, H_pad]).
    """
    n_pad = read_hap.shape[-1]
    scores = genotype_likelihoods_from_read_hap(read_hap, ploidy, counts)
    table = _table(enumerate_genotypes(n_pad, ploidy), read_hap, torch.long)
    if use_prior:
        lprior = log_genotype_prior(
            table.expand(len(read_hap), *table.shape), n_pad,
            inbreeding=inbreeding[:, None], frequencies=frequencies[:, None, :],
        )
        scores = scores + lprior.to(scores.dtype)
    valid = table.max(dim=-1).values[None, :] < n_valid[:, None]  # [B, G]
    scores = torch.where(valid, scores, -torch.inf)
    post = torch.exp(scores - torch.logsumexp(scores, dim=-1, keepdim=True))
    alleles, mode_prob, support_prob, _ = mode_genotype(post, ploidy, n_pad)
    freqs, _, occur = posterior_allele_frequencies(post, ploidy, n_pad)
    return alleles, mode_prob, support_prob, freqs, occur


def _problems_per_launch(n_reads, n_pad, ploidy, device):
    """How many problems one ``_exact_stats_batch`` call may take.

    Its largest tensors are the [B, R, G] dosage product and its log and
    count-weighted copies (three f64 tensors), then the [B, G, H]
    support mask and the [B, G, P] prior gathers: reckoned per problem
    against ``memory_budget``.
    """
    n_genotypes = count_unique_genotypes(n_pad, ploidy)
    per_problem = n_genotypes * (3 * 8 * n_reads + n_pad + 3 * 8 * ploidy)
    return max(1, memory_budget(device) // per_problem)


def exact_posterior_stats_multi(problems, ploidy, dtype=torch.float64, device=None):
    """Exact posterior-mode statistics for problems from MANY LOCI (the
    ``call-exact`` analogue of ``fit_calling_multi``'s cross-locus
    batching), on ``device`` (default ``cuda``; ``resolve_device``).

    Each problem: dict with ``reads`` (f[R_i, nb_i, A_i]), ``counts``
    (f[R_i]), ``haplotypes`` (i[H_i, nb_i]) and optionally
    ``inbreeding``/``frequencies``.  Panels pad to the block maximum
    (a power of two) with MIN_LOG read-hap columns, reads to a
    power-of-two bucket; each launch then computes the full VCF-ordered
    posterior of its problems (reference semantics
    calling/exact.py:156-249).  The block is split over problems where
    one launch would not fit the device (``_problems_per_launch``).

    A problem with ``inbreeding`` but no ``frequencies`` uses the
    uniform 1/H_i frequencies (the reference's ``frequencies=None``
    parametrisation, made explicit so panel padding cannot distort it).

    Returns a list of dicts with keys ``alleles``, ``mode_prob``,
    ``support_prob``, ``freqs``, ``occur`` (sliced to each problem's
    own panel size).
    """
    device = resolve_device(device)
    n_problems = len(problems)
    use_prior = any(p.get("inbreeding") is not None for p in problems)
    h_list = [len(p["haplotypes"]) for p in problems]
    h_max = 1
    while h_max < max(h_list):
        h_max *= 2

    rh_list = []
    for p in problems:
        rh = read_hap_loglik(prepare_reads(p["reads"], dtype), p["haplotypes"])
        pad = torch.full((rh.shape[0], h_max - rh.shape[1]), MIN_LOG, dtype=dtype)
        rh_list.append(torch.cat([rh, pad], dim=1))
    bucket = 8
    while bucket < max((len(r) for r in rh_list), default=1):
        bucket *= 2
    read_hap = torch.zeros((n_problems, bucket, h_max), dtype=dtype)
    counts = torch.zeros((n_problems, bucket), dtype=dtype)
    inbreeding = torch.zeros(n_problems, dtype=dtype)
    frequencies = torch.zeros((n_problems, h_max), dtype=dtype)
    for i, (rh, p) in enumerate(zip(rh_list, problems)):
        read_hap[i, : len(rh)] = rh
        counts[i, : len(rh)] = torch.as_tensor(np.asarray(p["counts"], float))
        inbreeding[i] = float(p.get("inbreeding") or 0.0)
        freqs = p.get("frequencies")
        if freqs is None:
            freqs = np.full(h_list[i], 1.0 / h_list[i])
        frequencies[i, : h_list[i]] = torch.as_tensor(np.asarray(freqs, float))
    n_valid = torch.as_tensor(h_list)

    step = _problems_per_launch(bucket, h_max, ploidy, device)
    parts = []
    for lo in range(0, n_problems, step):
        sl = slice(lo, lo + step)
        out = _exact_stats_batch(
            *(x[sl].to(device) for x in (read_hap, counts, n_valid, inbreeding, frequencies)),
            ploidy=ploidy, use_prior=use_prior,
        )
        parts.append([x.cpu().numpy() for x in out])
    alleles, mode_prob, support_prob, freqs, occur = (
        np.concatenate(x) for x in zip(*parts)
    )
    return [
        dict(
            alleles=alleles[i],
            mode_prob=float(mode_prob[i]),
            support_prob=float(support_prob[i]),
            freqs=freqs[i, : h_list[i]],
            occur=occur[i, : h_list[i]],
        )
        for i in range(n_problems)
    ]


def posterior_mode(
    reads,
    ploidy,
    haplotypes,
    read_counts=None,
    prior=None,
    return_support_prob=False,
    return_posterior_frequencies=False,
    return_posterior_occurrence=False,
    dtype=torch.float64,
    device=None,
):
    """Mode genotype + statistics; API of reference calling/exact.py:156-249.

    Unlike the reference's low-memory streaming scan, the full posterior
    is materialised on ``device`` (default ``cuda``; ``resolve_device``),
    one [R, G] matmul.
    """
    device = resolve_device(device)
    llks = genotype_likelihoods(reads, ploidy, haplotypes, read_counts, dtype, device)
    n_alleles = len(haplotypes)
    post = genotype_posteriors(llks, ploidy, n_alleles, prior=prior)
    alleles, mode_prob, support_prob, idx = mode_genotype(post, ploidy, n_alleles)
    result = [alleles.cpu().numpy(), float(llks[..., idx]), float(mode_prob)]
    if return_support_prob:
        result.append(float(support_prob))
    if return_posterior_frequencies or return_posterior_occurrence:
        freqs, _, occur = posterior_allele_frequencies(post, ploidy, n_alleles)
        if return_posterior_frequencies:
            result.append(freqs.cpu().numpy())
        if return_posterior_occurrence:
            result.append(occur.cpu().numpy())
    return tuple(result)
