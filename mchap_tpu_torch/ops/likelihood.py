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
