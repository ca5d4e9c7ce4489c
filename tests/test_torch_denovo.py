"""K1 (the de novo sampler): the port's plain version against the JAX kernel.

With its noise pinned at 1e-12, the plain PyTorch version must retrace
the Pallas kernel run in interpret mode, whose PRNG is a no-op that
yields the same 1e-12 for every draw: identical packed traces, and llks
within 1e-4 (only the f32 summation order differs).  Ploidy 4 is in
test_torch_denovo_tetraploid.py.  With its own
``torch.Generator`` the plain version must sample the exact posterior.
"""

import numpy as np
import pytest
import torch

from mchap_tpu.ops import exact as jexact
from mchap_tpu_torch.numerics.combinadics import genotype_alleles_as_index
from mchap_tpu_torch.ops import cuda_denovo as K
from mchap_tpu_torch.ops.likelihood import prepare_reads
from mchap_tpu_torch.testing import simulate_reads
from test_torch_fixtures import k1_case, k1_compare_with_pallas

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("A", [2, 4])
def test_plain_matches_pallas_interpret_diploid(A, stage):
    k1_compare_with_pallas(2, A, stage)


def test_plain_sampler_matches_exact_posterior():
    """Gate problem of scripts/gate_pallas_denovo.py: P4, 2 SNVs, 8 reads."""
    P, nb, A = 4, 2, 2
    haplotypes = np.array([[0, 0], [0, 1], [1, 1], [0, 0]], np.int8)
    reads = simulate_reads(
        haplotypes, n_alleles=A, n_reads=8, errors=False, uniform_sample=True,
        qual=(20, 20), seed=11,
    )
    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    want = np.asarray(
        jexact.genotype_posteriors(
            jexact.genotype_likelihoods(reads, P, panel), P, len(panel)
        )
    )
    chains, steps, burn = 384, 120, 30
    rng = np.random.default_rng(0)
    lr = prepare_reads(reads, dtype=torch.float32).permute(1, 2, 0)[None].contiguous()
    trace, _ = K.denovo_sampler(
        lr,
        torch.ones((1, len(reads))),
        torch.from_numpy(rng.integers(0, A, size=(P, nb, chains)).astype(np.int32)),
        torch.full((1, nb), A, dtype=torch.int32),
        torch.full((1,), 0.25),
        torch.zeros(chains, dtype=torch.int32),
        n_steps=steps, seed=11,
    )
    g = K.unpack_genotype_trace(trace.numpy()[burn:], P, A)  # [T, P, NB, C]
    codes = np.sort(g[:, :, 0, :] * 2 + g[:, :, 1, :], axis=1)
    idx = genotype_alleles_as_index(codes.transpose(0, 2, 1).reshape(-1, P))
    got = np.bincount(idx, minlength=len(want)).astype(float)
    got /= got.sum()
    tv = 0.5 * np.abs(got - want).sum()
    assert tv < 0.05, tv


def test_wrapper_rejects_bad_inputs():
    lr, counts, g0, nall, pbreak, prob = k1_case(2, 2, seed=0)
    args = [torch.from_numpy(x) for x in (lr, counts, g0, nall, pbreak, prob)]
    with pytest.raises(ValueError, match="float32"):
        K.denovo_sampler(args[0].double(), *args[1:], n_steps=2)
    with pytest.raises(ValueError, match="shape"):
        K.denovo_sampler(*args[:5], args[5][:-1], n_steps=2)
    with pytest.raises(ValueError, match="stage"):
        K.denovo_sampler(*args, n_steps=2, stage=4)
