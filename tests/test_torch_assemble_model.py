"""The port's assemble model layer against ``mchap_tpu``.

- The kernel-path wrapper with pinned noise against
  ``_fit_denovo_batch_pallas(interpret=True)``: het compaction, burn,
  and device tabulation on and off, and a tempering ladder with
  per-sample Dirichlet-multinomial dispersions.  Genotypes identical,
  llks within 1e-4 (f32 summation order).
- Combinadics, the dosage table, the homozygosity screen (flat and with
  the prior) and exact genotype likelihoods/posteriors: f64, 1e-6
  relative.
- What K1 cannot run raises NotImplementedError before any work.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mchap_tpu.models.assemble import _fit_denovo_batch_pallas
from mchap_tpu.numerics import combinadics as jcomb
from mchap_tpu.ops import assemble_mcmc as jscreen
from mchap_tpu.ops import exact as jexact
from mchap_tpu.ops.likelihood import prepare_reads as jprepare
from mchap_tpu.testing import simulate_reads
from mchap_tpu_torch.models.assemble import (
    DenovoMCMC,
    GenotypeMultiTrace,
    TabulatedGenotypeTrace,
    _fit_denovo_batch_kernel,
    fit_denovo_multi,
)
from mchap_tpu_torch.numerics import combinadics as comb
from mchap_tpu_torch.ops import assemble_mcmc as screen
from mchap_tpu_torch.ops import exact

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


def _wrapper_case(P, NB, A, n_samples, chains, het_sets=None, seed=0, n_reads=8):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, A, size=(n_samples, P, NB)).astype(np.int8)
    reads = np.stack([
        simulate_reads(t, n_alleles=A, n_reads=n_reads, errors=False, seed=i)
        for i, t in enumerate(truth)
    ])
    counts = np.ones((n_samples, reads.shape[1]))
    log_reads = np.asarray(jprepare(reads, dtype=jnp.float32))
    init = rng.integers(0, A, size=(n_samples, chains, P, NB)).astype(np.int32)
    nall = np.full((n_samples, NB), A, np.int32)
    if het_sets is not None:
        nall[:] = 1
        fixed = rng.integers(0, A, size=(n_samples, NB)).astype(np.int32)
        for i, hs in enumerate(het_sets):
            nall[i, list(hs)] = A
            keep = np.zeros(NB, bool)
            keep[list(hs)] = True
            init[i, :, :, ~keep] = fixed[i, ~keep][:, None, None]
    break_dist = np.zeros((n_samples, NB))
    break_dist[:, 0] = 0.75
    break_dist[:, 1] = 0.25
    return log_reads, counts, init, nall, break_dist


# "plain", "burn" and "compaction" (12 positions compacted to 8) give the
# JAX kernel the same static shapes, so the interpreter compiles it once
WRAPPER_CASES = {
    # (P, NB, A, samples, chains, steps, burn, het_sets)
    "plain": (4, 8, 2, 3, 2, 6, 0, None),
    "burn": (4, 8, 2, 2, 2, 6, 4, None),
    "compaction": (4, 12, 2, 3, 2, 6, 2, [(0, 5, 11), (2, 3, 7, 10), (1, 6, 9)]),
    "triallelic": (2, 6, 3, 2, 3, 5, 1, None),
}


@pytest.mark.parametrize("tabulate", [False, True])
@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_kernel_wrapper_matches_pallas_wrapper(case, tabulate):
    P, NB, A, S, chains, steps, burn, het_sets = WRAPPER_CASES[case]
    log_reads, counts, init, nall, break_dist = _wrapper_case(
        P, NB, A, S, chains, het_sets
    )
    kw = dict(p_recomb=0.5, p_partial=0.5, p_full=1.0, burn=burn, tabulate=tabulate)
    want = _fit_denovo_batch_pallas(
        log_reads, counts, init, nall, break_dist, P, steps, chains, seed=7,
        interpret=True, mesh=None, **kw,
    )
    got = _fit_denovo_batch_kernel(
        log_reads, counts, init, nall, break_dist, P, steps, chains, seed=7,
        device=torch.device("cpu"), pinned_noise=1e-12, **kw,
    )
    kind = TabulatedGenotypeTrace if tabulate and steps > burn else GenotypeMultiTrace
    for g, w in zip(got, want):
        assert type(g) is kind and type(w).__name__ == kind.__name__
        assert g.pre_burned == w.pre_burned == burn
        if kind is GenotypeMultiTrace:
            np.testing.assert_array_equal(g.genotypes, w.genotypes)
        else:
            np.testing.assert_array_equal(g.states, w.states)
            np.testing.assert_array_equal(g.counts, w.counts)
            np.testing.assert_array_equal(g.first, w.first)
        np.testing.assert_allclose(g.llks, w.llks, rtol=0, atol=1e-4)
        post_g, post_w = g.posterior(), w.posterior()
        np.testing.assert_array_equal(post_g.genotypes, post_w.genotypes)
        np.testing.assert_allclose(post_g.probabilities, post_w.probabilities)


def test_kernel_wrapper_matches_pallas_wrapper_modes():
    P, NB, A, S, chains, steps, burn = 4, 8, 2, 3, 2, 6, 1
    log_reads, counts, init, nall, break_dist = _wrapper_case(P, NB, A, S, chains, seed=3)
    temps, alphas = (0.5, 1.0), np.array([0.02, 0.4, 3.0])
    kw = dict(p_recomb=0.5, p_partial=0.5, p_full=1.0, burn=burn,
              temperatures=temps, alphas=alphas)
    want = _fit_denovo_batch_pallas(
        log_reads, counts, init, nall, break_dist, P, steps, chains, seed=7,
        interpret=True, mesh=None, **kw,
    )
    got = _fit_denovo_batch_kernel(
        log_reads, counts, init, nall, break_dist, P, steps, chains, seed=7,
        device=torch.device("cpu"), pinned_noise=1e-12, **kw,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.genotypes, w.genotypes)
        np.testing.assert_allclose(g.llks, w.llks, rtol=0, atol=1e-4)


def test_combinadics_match_jax():
    rng = np.random.default_rng(0)
    for ploidy, n in [(2, 5), (4, 4), (6, 3)]:
        np.testing.assert_array_equal(
            comb.enumerate_genotypes(n, ploidy), jcomb.enumerate_genotypes(n, ploidy)
        )
        assert comb.count_unique_genotypes(n, ploidy) == jcomb.count_unique_genotypes(n, ploidy)
        alleles = np.sort(rng.integers(0, n, size=(50, ploidy)), axis=1)
        np.testing.assert_array_equal(
            comb.genotype_alleles_as_index(alleles),
            np.asarray(jcomb.genotype_alleles_as_index(alleles)),
        )


def test_exact_and_screen_match_jax(monkeypatch):
    rng = np.random.default_rng(1)
    P, NB, A = 4, 5, 3
    haps = rng.integers(0, A, size=(P, NB))
    reads = simulate_reads(haps, n_alleles=A, n_reads=12, seed=2)
    counts = rng.integers(1, 4, size=len(reads)).astype(float)
    panel = rng.integers(0, A, size=(6, NB))
    np.testing.assert_array_equal(
        exact.genotype_dosage_table(6, P), jexact.genotype_dosage_table(6, P)
    )
    gl = exact.genotype_likelihoods(reads, P, panel, counts).numpy()
    want_gl = np.asarray(jexact.genotype_likelihoods(reads, P, panel, counts))
    np.testing.assert_allclose(gl, want_gl, rtol=1e-6)
    np.testing.assert_allclose(
        exact.genotype_posteriors(torch.from_numpy(gl)).numpy(),
        np.asarray(jexact.genotype_posteriors(want_gl, P, len(panel))),
        rtol=1e-6, atol=1e-12,
    )
    # homozygosity screen over a padded batch of samples: against the
    # JAX package's XLA screen, not its numpy copy
    monkeypatch.setenv("MCHAP_HOM_SCREEN", "device")
    reads_b = np.stack([reads, simulate_reads(haps, n_alleles=A, n_reads=12, seed=3)])
    reads_b[1, -3:] = np.nan
    counts_b = np.stack([counts, np.ones(len(reads))])
    nall = np.array([[3, 3, 2, 3, 1], [3, 2, 3, 3, 3]])
    got = screen.homozygosity_probabilities_batch(reads_b, nall, P, read_counts_b=counts_b)
    want = np.asarray(jscreen.homozygosity_probabilities_batch(
        reads_b, nall, P, read_counts_b=counts_b
    ))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # with the Dirichlet-multinomial prior: per sample F, per position
    # allele count (F == 0 takes the flat branch of the prior)
    for F in ([0.1, 0.5], [0.3, 0.0]):
        got = screen.homozygosity_probabilities_batch(
            reads_b, nall, P, read_counts_b=counts_b, inbreeding_b=F
        )
        want = np.asarray(jscreen.homozygosity_probabilities_batch(
            reads_b, nall, P, use_prior=True, inbreeding_b=np.asarray(F),
            read_counts_b=counts_b,
        ))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_denovo_mcmc_fit_and_unported_options():
    haps = np.array([[0, 0, 1], [0, 1, 1], [1, 1, 0], [0, 0, 1]])
    reads = simulate_reads(haps, n_alleles=2, n_reads=16, errors=False, seed=4)
    trace = DenovoMCMC(ploidy=4, n_alleles=[2, 2, 2], steps=30, chains=2,
                       random_seed=1, device="cpu").fit(reads)
    assert trace.genotypes.shape == (2, 30, 4, 3)
    assert np.isfinite(trace.llks).all()
    trace = DenovoMCMC(ploidy=4, n_alleles=[2, 2, 2], inbreeding=0.1, steps=30,
                       chains=2, temperatures=(0.5, 1.0), random_seed=1,
                       device="cpu").fit(reads)
    assert trace.genotypes.shape == (2, 30, 4, 3)
    assert np.isfinite(trace.llks).all()
    # what K1 cannot run: a prior over samples some of which have F = 0,
    # 9 rungs, ploidy 9
    problem = dict(reads=reads, counts=np.ones(len(reads)), n_alleles=[2, 2, 2])
    with pytest.raises(NotImplementedError, match="inbreeding 0.*ROADMAP queue 1, item 2"):
        fit_denovo_multi([dict(problem, inbreeding=0.1), dict(problem, inbreeding=0.0)],
                         4, steps=5, device="cpu")
    with pytest.raises(NotImplementedError, match="9 tempering rungs"):
        fit_denovo_multi([problem], 4, steps=5, device="cpu",
                         temperatures=[0.1 * i for i in range(2, 10)] + [1.0])
    with pytest.raises(NotImplementedError, match="ploidy 9"):
        DenovoMCMC(ploidy=9, n_alleles=[2, 2, 2], device="cpu").fit(reads)
