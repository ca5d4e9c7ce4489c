"""Test-support utilities: the read simulator.

Same role as reference ``mchap/testing.py``: ``simulate_reads`` generates
probabilistically-encoded reads from ground-truth haplotypes.  A copy of
``mchap_tpu.testing.simulate_reads`` (numpy only).
"""

import numpy as np

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
