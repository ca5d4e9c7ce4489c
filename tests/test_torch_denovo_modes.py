"""K1's tempering ladder and Dirichlet-multinomial prior: the port's
plain version against the JAX kernel and against exact enumeration.

- With its noise pinned at 1e-12, the plain version must retrace
  ``pallas_denovo_sampler(..., interpret=True)`` (whose PRNG yields 1e-12
  for every draw, so nearly every move and swap is taken) with a ladder,
  with per-problem dispersions ``alphas_cl`` and with both: identical
  packed traces, llks within 1e-4 (f32 summation order).
- With its own generator it must sample the exact posterior (JAX
  ``exact.genotype_posteriors``, flat or with ``prior=(F, None)``) of a
  problem where the prior moves the posterior: TV < 0.05, while the
  flat and the prior posteriors lie more than 0.15 apart.
- ``k1_unsupported_reason`` names what K1 cannot run.
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

ALPHAS = [0.05, 0.3, 1.5, 0.01]  # one per problem of k1_case

PALLAS_CASES = {
    # (P, A, temps, alphas)
    "tempered-P2": (2, 2, [0.5, 1.0], None),
    "dirmul-P2-A3": (2, 3, None, ALPHAS),
    "both-P4": (4, 2, [0.33, 0.66, 1.0], ALPHAS),
    "both-P2-A4": (2, 4, [0.4, 0.7, 1.0], ALPHAS),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_plain_matches_pallas_interpret_modes(case):
    P, A, temps, alphas = PALLAS_CASES[case]
    k1_compare_with_pallas(P, A, 3, temps=temps, alpha=alphas)


F = 0.5
TEMPS = [0.33, 0.66, 1.0]
P4, NB2, A2 = 4, 2, 2


def _low_depth_problem(prior):
    """P4, 2 SNVs, 6 low-quality reads: the gate problem of
    scripts/gate_pallas_denovo.py at a depth where F = 0.5 matters.
    Returns the read tensor, the flat and the target posterior."""
    haplotypes = np.array([[0, 0], [0, 1], [1, 1], [0, 0]], np.int8)
    reads = simulate_reads(
        haplotypes, n_alleles=A2, n_reads=6, errors=False, uniform_sample=True,
        qual=(12, 16), seed=11,
    )
    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    gl = jexact.genotype_likelihoods(reads, P4, panel)
    flat = np.asarray(jexact.genotype_posteriors(gl, P4, len(panel)))
    want = np.asarray(
        jexact.genotype_posteriors(gl, P4, len(panel), prior=(F, None) if prior else None)
    )
    lr = prepare_reads(reads, dtype=torch.float32).permute(1, 2, 0)[None].contiguous()
    return lr, flat, want


def _run_plain(lr, g_init, *, n_steps, seed, prior, temps=None, stage=3):
    chains = g_init.shape[-1]
    return K.denovo_sampler(
        lr,
        torch.ones((1, lr.shape[-1])),
        torch.from_numpy(g_init.astype(np.int32)),
        torch.full((1, NB2), A2, dtype=torch.int32),
        torch.full((1,), 0.25),
        torch.zeros(chains, dtype=torch.int32),
        n_steps=n_steps, seed=seed, temps=temps, stage=stage,
        # u_haps = 4 haplotypes over the two biallelic SNVs
        alpha=torch.tensor([(1 - F) / F / 4]) if prior else None,
    )[0].numpy()


def _tv(trace, want, burn):
    g = K.unpack_genotype_trace(trace[burn:], P4, A2)  # [T, P, NB, C]
    codes = np.sort(g[:, :, 0, :] * 2 + g[:, :, 1, :], axis=1)
    idx = genotype_alleles_as_index(codes.transpose(0, 2, 1).reshape(-1, P4))
    got = np.bincount(idx, minlength=len(want)).astype(float)
    got /= got.sum()
    return 0.5 * np.abs(got - want).sum()


@pytest.mark.parametrize(
    "temps, prior", [(TEMPS, False), (None, True), (TEMPS, True)],
    ids=["tempered", "dirmul", "both"],
)
def test_plain_sampler_matches_exact_posterior_modes(temps, prior):
    lr, flat, want = _low_depth_problem(prior)
    g0 = np.random.default_rng(0).integers(0, A2, size=(P4, NB2, 256))
    trace = _run_plain(lr, g0, n_steps=120, seed=11, prior=prior, temps=temps)
    tv = _tv(trace, want, burn=30)
    assert tv < 0.05, tv
    if prior:
        assert 0.5 * np.abs(flat - want).sum() > 0.15


def test_row_order_bias_of_structural_steps():
    """K1's chain, whose move set is the JAX kernel's, is biased on this
    diffuse problem once stage 3's full-length dosage step runs: a dosage move
    copies row b into the first row of its class, so copies gather at
    low row indices, and the mutation sweep visits rows in a fixed
    order.  Permuting each chain's rows at random before every step
    removes the excess.  A repair of the fault moves the first TV below
    the bound of the second."""
    lr, _, want = _low_depth_problem(prior=True)
    g0 = np.random.default_rng(0).integers(0, A2, size=(P4, NB2, 256))
    steps, burn = 300, 100
    straight = _tv(_run_plain(lr, g0, n_steps=steps, seed=11, prior=True), want, burn)
    perm_rng = np.random.default_rng(5)
    g, rows = g0, []
    for step in range(steps):
        trace = _run_plain(lr, g, n_steps=1, seed=1000 + step, prior=True)
        rows.append(trace[0])
        g = K.unpack_genotype_trace(trace, P4, A2)[0]  # [P, NB, C]
        order = np.argsort(perm_rng.random((P4, g.shape[-1])), axis=0)
        g = np.take_along_axis(g, order[:, None, :], axis=0)
    permuted = _tv(np.stack(rows), want, burn)
    assert straight > 0.018, straight
    assert permuted < 0.012, permuted


def test_k1_unsupported_reason():
    assert K.k1_unsupported_reason(4, 64, 16, 4, [0.1, 0.2]) is None
    assert K.k1_unsupported_reason(8, 64, 16, 8, None) is None
    assert "ploidy 9" in K.k1_unsupported_reason(9, 64, 16, 1, None)
    assert "9 tempering rungs" in K.k1_unsupported_reason(4, 64, 16, 9, None)
    assert "inbreeding 0" in K.k1_unsupported_reason(4, 64, 16, 1, [0.1, 0.0])
    assert "shared memory" in K.k1_unsupported_reason(4, 8192, 16, 1, None)
    # a ladder multiplies a chain's shared memory by its rungs
    assert K.k1_unsupported_reason(4, 2048, 16, 1, None) is None
    assert "shared memory" in K.k1_unsupported_reason(4, 2048, 16, 4, None)
    # the read count is not known when the CLI checks its options
    assert K.k1_unsupported_reason(4, None, 0, 2, [0.1]) is None


def test_wrapper_rejects_bad_ladders_and_alphas():
    args = [torch.from_numpy(x) for x in k1_case(2, 2, seed=0)]
    with pytest.raises(ValueError, match="ascend"):
        K.denovo_sampler(*args, n_steps=2, temps=[1.0, 0.5])
    with pytest.raises(ValueError, match="ascend"):
        K.denovo_sampler(*args, n_steps=2, temps=[0.5, 0.9])
    with pytest.raises(ValueError, match="temperatures"):
        K.denovo_sampler(*args, n_steps=2, temps=[0.1 * i for i in range(1, 10)] + [1.0])
    with pytest.raises(ValueError, match="alpha"):
        K.denovo_sampler(*args, n_steps=2, alpha=torch.ones(3))
    # a ladder's noise holds every rung's draws and the swap draws
    D = K.draw_layout(2, args[0].shape[1])["D"]
    with pytest.raises(ValueError, match="noise"):
        K.denovo_sampler(*args, n_steps=2, temps=[0.5, 1.0],
                         noise=torch.full((2, D, args[5].shape[0]), 0.5))
