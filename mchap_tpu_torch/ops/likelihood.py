"""Read-pileup log-likelihoods (PyTorch).

Port of ``mchap_tpu/ops/likelihood.py``: the per-read, per-haplotype
product over positions is one matmul of the log-read tensor against
one-hot haplotypes (``read_hap_loglik``).

Conventions
-----------
- ``reads``: float[..., R, P, A] probabilistic read matrices; ``nan``
  marks a gap (no observation), as in the reference encoding.
- ``log_reads`` = log(reads) with gaps replaced by log(1) = 0 and zeros
  clamped to ``MIN_LOG`` so that 0 * log(0) never produces nan.
"""

import math

import numpy as np
import torch

# Large negative stand-in for log(0): finite so 0 * MIN_LOG == 0 inside
# the one-hot matmul, yet small enough that exp() underflows to 0.
MIN_LOG = -1e30


def prepare_reads(reads, dtype=torch.float64, device=None):
    """Probabilistic reads -> log-domain tensor.

    nan (gap) -> 0.0 (multiplicative identity); 0.0 -> MIN_LOG.
    """
    reads = torch.as_tensor(np.asarray(reads), dtype=dtype, device=device)
    logs = torch.log(torch.where(torch.isnan(reads), 1.0, reads))
    return torch.clamp(logs, min=MIN_LOG)


def read_hap_loglik(log_reads, haplotypes):
    """log P(read r | haplotype k) for every read x haplotype pair.

    log_reads: float[..., R, P, A]; haplotypes: int[K, P], where a
    negative (null) allele selects no column and contributes log 1.
    Returns float[..., R, K].
    """
    n_alleles = log_reads.shape[-1]
    haplotypes = torch.as_tensor(
        np.asarray(haplotypes), dtype=torch.long, device=log_reads.device
    )
    alleles = torch.arange(n_alleles, device=log_reads.device)
    onehot = (haplotypes[..., None] == alleles).to(log_reads.dtype)
    return torch.einsum("...rpa,kpa->...rk", log_reads, onehot)


def log_likelihood_from_read_hap(read_hap, genotype, read_counts=None):
    """llk of a genotype given the precomputed read x haplotype matrix.

    read_hap float[..., R, K]; genotype int[..., ploidy] indices into the
    K axis; read_counts float[..., R] or None.  Per read, the mean over
    the ploidy haplotypes of each one's probability; log; weighted sum
    over reads (reference ``log_likelihood``, assemble/likelihood.py:17-70).
    """
    read_hap = torch.as_tensor(read_hap)
    genotype = torch.as_tensor(np.asarray(genotype), dtype=torch.long, device=read_hap.device)
    ploidy = genotype.shape[-1]
    index = genotype[..., None, :].expand(read_hap.shape[:-1] + (ploidy,))
    sub = torch.gather(read_hap, -1, index)  # [..., R, ploidy]
    read_log = torch.logsumexp(sub, dim=-1) - math.log(ploidy)
    if read_counts is not None:
        read_log = read_log * torch.as_tensor(read_counts, dtype=read_log.dtype)
    return read_log.sum(dim=-1)


def log_likelihood(reads, genotype, read_counts=None, dtype=torch.float64):
    """llk of a genotype of haplotypes int[..., ploidy, P] given
    probabilistic reads [R, P, A]; reference ``log_likelihood``
    (assemble/likelihood.py:17-70)."""
    rh = read_hap_loglik(prepare_reads(reads, dtype), genotype)  # [..., R, ploidy]
    ploidy = np.shape(genotype)[-2]
    read_log = torch.logsumexp(rh, dim=-1) - math.log(ploidy)
    if read_counts is not None:
        read_log = read_log * torch.as_tensor(np.asarray(read_counts), dtype=rh.dtype)
    return read_log.sum(dim=-1)
