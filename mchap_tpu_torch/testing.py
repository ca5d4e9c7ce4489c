"""Test-support utilities: the read simulator and the pedigree oracle.

Same role as reference ``mchap/testing.py``: ``simulate_reads`` generates
probabilistically-encoded reads from ground-truth haplotypes (a copy of
``mchap_tpu.testing.simulate_reads``, numpy only), and
``exact_pedigree_marginals`` enumerates a small pedigree's joint
posterior, the oracle that gates the pedigree samplers.
"""

import itertools

import numpy as np
import torch

from mchap_tpu_torch.constant import PFEIFFER_ERROR
from mchap_tpu_torch.encoding.integer import as_probabilistic
from mchap_tpu_torch.io.util import prob_of_qual


def simulate_reads(
    haplotypes,
    n_alleles=None,
    n_reads=20,
    uniform_sample=False,
    errors=True,
    error_rate=PFEIFFER_ERROR,
    qual=(30, 60),
    seed=None,
):
    """Simulate probabilistic reads from haplotypes (tests only).

    Reference: testing.py:9-73.  Reads sample haplotypes (uniformly or at
    random), get random per-base quals in ``qual``, and are optionally
    resampled from their own probability distributions to inject errors.
    """
    rng = np.random.default_rng(seed)
    haplotypes = np.asarray(haplotypes)
    ploidy, _ = haplotypes.shape
    if n_alleles is None:
        n_alleles = int(haplotypes.max()) + 1

    if uniform_sample:
        read_haps = np.tile(haplotypes, (n_reads // ploidy, 1))
    else:
        read_haps = haplotypes[rng.integers(0, ploidy, n_reads)]

    quals = rng.integers(qual[0], qual[1] + 1, size=read_haps.shape)
    probs = prob_of_qual(quals) * (1 - error_rate)
    reads = as_probabilistic(read_haps, n_alleles, p=probs)

    if errors:
        # resample alleles from the encoded distributions
        flat = reads.reshape(-1, reads.shape[-1])
        sums = np.nansum(flat, axis=-1, keepdims=True)
        dists = np.where(np.isnan(flat), 0.0, flat) / sums
        cdf = np.cumsum(dists, axis=-1)
        u = rng.random((len(flat), 1))
        read_haps = (u > cdf).sum(axis=-1).reshape(read_haps.shape).astype(np.int8)
        reads = as_probabilistic(read_haps, n_alleles, p=probs)

    return reads


def exact_pedigree_marginals(sample_llks, sample_parents, gamete_tau,
                             gamete_lambda, gamete_error, n_haps, ploidy,
                             log_frequencies=None):
    """Brute-force per-sample posterior marginals of a small pedigree.

    Enumerates all G^S joint genotype assignments (G = C(n_haps + ploidy
    - 1, ploidy)) of the joint density prod_i llk_i x trio_i (reference
    pedigree model) in f64 on the CPU and returns [S, G] marginals.
    ``sample_llks`` f[S, G] holds per-sample genotype log-likelihoods in
    VCF genotype order (``ops/exact.genotype_likelihoods``).  Port of
    ``mchap_tpu.testing.exact_pedigree_marginals`` on the port's
    ``trio_log_pmf``.
    """
    from mchap_tpu_torch.numerics.combinadics import enumerate_genotypes
    from mchap_tpu_torch.ops import pedigree_mcmc as K

    sample_llks = torch.as_tensor(np.asarray(sample_llks, float))
    parents = np.asarray(sample_parents, int)
    tau = np.asarray(gamete_tau, int)
    lam = np.asarray(gamete_lambda, float)
    err = np.asarray(gamete_error, float)
    n_samples, G = sample_llks.shape
    table = torch.as_tensor(np.array(enumerate_genotypes(n_haps, ploidy)), dtype=torch.long)
    if log_frequencies is None:
        log_frequencies = np.log(np.full(n_haps, 1.0 / n_haps))
    tables, valid = K.composition_tables(ploidy)
    tables = torch.as_tensor(tables, dtype=torch.long)
    valid = torch.as_tensor(valid)
    lut = torch.as_tensor(K._COMB_LUT)
    lf = torch.as_tensor(np.asarray(log_frequencies, float))
    combos = torch.as_tensor(
        np.asarray(list(itertools.product(range(G), repeat=n_samples)), np.int64)
    )
    missing = torch.full((len(combos), ploidy), -1, dtype=torch.long)
    logs = torch.zeros(len(combos), dtype=torch.float64)
    for i in range(n_samples):
        p, q = int(parents[i, 0]), int(parents[i, 1])
        has_p, has_q = p >= 0, q >= 0
        logs += sample_llks[i, combos[:, i]]
        logs += K.trio_log_pmf(
            table[combos[:, i]],
            table[combos[:, p]] if has_p else missing,
            table[combos[:, q]] if has_q else missing,
            ploidy if has_p else 0, ploidy if has_q else 0,
            int(tau[i, 0]), int(tau[i, 1]),
            float(lam[i, 0]), float(lam[i, 1]),
            float(err[i, 0]) if has_p else 1.0, float(err[i, 1]) if has_q else 1.0,
            lf, tables, valid, lut,
        )
    w = torch.exp(logs - logs.max())
    w = (w / w.sum()).numpy()
    marginals = np.zeros((n_samples, G))
    for i in range(n_samples):
        np.add.at(marginals[i], combos[:, i].numpy(), w)
    return marginals
