"""K1 above ploidy 8: the port's plain version against exact enumeration
(its comparison with the JAX kernel at ploidy 9 is
``test_torch_denovo_ploidy9.py``, a file of its own so that the two run
on two test workers).

With its kernel's own Philox stream the plain version samples the exact
posterior of a ploidy 10 and a ploidy 12 problem over two biallelic
SNVs (286 and 455 genotypes) within the bound of
``test_plain_sampler_matches_exact_posterior``.
"""

import numpy as np
import pytest
import torch

from mchap_tpu.ops import exact as jexact
from mchap_tpu_torch.numerics.combinadics import genotype_alleles_as_index
from mchap_tpu_torch.ops import cuda_denovo as K
from mchap_tpu_torch.ops.likelihood import prepare_reads
from mchap_tpu_torch.testing import simulate_reads

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("P", [10, 12])
def test_plain_sampler_matches_exact_posterior_high_ploidy(P):
    """20 or 30 s: 256 chains x 60 steps on 2 SNVs, 2 reads per
    haplotype copy at quality 20."""
    haplotypes = np.array([[0, 0], [0, 1], [1, 1], [0, 0]] * 3, np.int8)[:P]
    reads = simulate_reads(
        haplotypes, n_alleles=2, n_reads=2 * P, errors=False, uniform_sample=True,
        qual=(20, 20), seed=11,
    )
    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    want = np.asarray(
        jexact.genotype_posteriors(
            jexact.genotype_likelihoods(reads, P, panel), P, len(panel)
        )
    )
    chains, steps, burn = 256, 60, 20
    rng = np.random.default_rng(0)
    lr = prepare_reads(reads, dtype=torch.float32).permute(1, 2, 0)[None].contiguous()
    trace, _ = K.denovo_sampler(
        lr,
        torch.ones((1, len(reads))),
        torch.from_numpy(rng.integers(0, 2, size=(P, 2, chains)).astype(np.int32)),
        torch.full((1, 2), 2, dtype=torch.int32),
        torch.full((1,), 0.25),
        torch.zeros(chains, dtype=torch.int32),
        n_steps=steps, seed=11,
    )
    g = K.unpack_genotype_trace(trace.numpy()[burn:], P, 2)  # [T, P, NB, C]
    codes = np.sort(g[:, :, 0, :] * 2 + g[:, :, 1, :], axis=1)
    idx = genotype_alleles_as_index(codes.transpose(0, 2, 1).reshape(-1, P))
    got = np.bincount(idx, minlength=len(want)).astype(float)
    got /= got.sum()
    tv = 0.5 * np.abs(got - want).sum()
    assert tv < 0.05, tv
