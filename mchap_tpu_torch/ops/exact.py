"""Exact genotype enumeration (PyTorch).

Port of the parts of ``mchap_tpu/ops/exact.py`` that the assemble path
uses: the dosage table (homozygosity screen), genotype likelihoods of
every VCF-ordered genotype (``--report GL``) and flat-prior genotype
posteriors (the exact oracle that gates the de novo sampler).

P(read | genotype) = (1/ploidy) * sum_k dosage[g, k] * P(read | hap k),
so all genotypes are scored with one [R, K] x [K, G] matmul.
"""

import numpy as np
import torch

from mchap_tpu_torch.numerics.combinadics import enumerate_genotypes
from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik


def genotype_dosage_table(n_alleles: int, ploidy: int) -> np.ndarray:
    """Dense [G, K] dosage matrix of the VCF-ordered genotype table."""
    table = enumerate_genotypes(n_alleles, ploidy)  # [G, ploidy]
    dosage = np.zeros((table.shape[0], n_alleles), np.int32)
    rows = np.repeat(np.arange(table.shape[0]), ploidy)
    np.add.at(dosage, (rows, table.ravel()), 1)
    return dosage


def genotype_likelihoods_from_read_hap(read_hap, ploidy, read_counts=None):
    """llk of every VCF-ordered genotype from the [.., R, K] read-hap matrix.

    Reference ``_genotype_likelihoods`` (calling/exact.py:252-263),
    evaluated as one dosage matmul with a per-read scale for stability.
    """
    n_alleles = read_hap.shape[-1]
    dosage = torch.as_tensor(
        genotype_dosage_table(n_alleles, ploidy),
        dtype=read_hap.dtype, device=read_hap.device,
    )  # [G, K]
    floor = -1e300 if read_hap.dtype == torch.float64 else -1e30
    m = torch.clamp(read_hap.max(dim=-1).values, min=floor)  # [.., R]
    e = torch.exp(read_hap - m[..., None])
    probs = torch.einsum("...rk,gk->...rg", e, dosage)
    read_log = torch.log(probs) + m[..., None] - np.log(ploidy)
    if read_counts is not None:
        counts = torch.as_tensor(
            np.asarray(read_counts), dtype=read_hap.dtype,
            device=read_hap.device,
        )
        read_log = read_log * counts[..., None]
    return read_log.sum(dim=-2)  # [.., G]


def genotype_likelihoods(reads, ploidy, haplotypes, read_counts=None,
                         dtype=torch.float64, device=None):
    """llk of every possible genotype; reference calling/exact.py:266-292."""
    log_reads = prepare_reads(reads, dtype, device)
    read_hap = read_hap_loglik(log_reads, haplotypes)
    return genotype_likelihoods_from_read_hap(read_hap, ploidy, read_counts)


def genotype_posteriors(log_likelihoods):
    """Flat-prior posterior over all genotypes; reference
    calling/exact.py:295-329 with ``prior=None``."""
    llks = torch.as_tensor(log_likelihoods)
    return torch.exp(llks - torch.logsumexp(llks, dim=-1, keepdim=True))
