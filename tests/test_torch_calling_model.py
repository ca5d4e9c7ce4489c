"""``models/calling.py`` of the port against ``mchap_tpu.models.calling``.

- The kernel-path wrapper (``_fit_batch_kernel``, K2's plain version on
  the CPU with every uniform pinned at 1e-12) against
  ``_fit_batch_pallas(interpret=True, mesh=None)``, whose interpreter PRNG
  gives 1e-12 for every draw: heterogeneous panels, burn-in, genotypes
  identical.
- ``GenotypeAllelesMultiTrace`` and ``PosteriorGenotypeAllelesDistribution``
  against JAX's on the same numpy arrays.
- ``fit_calling_multi`` (flat prior through K2's plain version; priors
  through the torch sampler) against exact posteriors, and, with one
  problem, as ``CallingMCMC.fit`` runs it, bit for bit against the
  traces of the one-locus batch fit it replaced.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mchap_tpu.models import calling as jax_calling
from mchap_tpu.ops import exact as jax_exact
from mchap_tpu.ops.likelihood import MIN_LOG
from mchap_tpu.testing import simulate_reads
from mchap_tpu_torch.models import calling

torch.set_num_threads(1)

HAPS = np.array(
    [[0, 0, 0, 0], [0, 0, 1, 1], [1, 1, 0, 0], [1, 1, 1, 1]], dtype=np.int8
)


@pytest.mark.parametrize("ploidy", [2, 4])
def test_kernel_wrapper_matches_pallas_wrapper(ploidy):
    rng = np.random.default_rng(ploidy)
    S, R, H, chains, steps, burn = 5, 16, 6, 3, 7, 2
    n_valid = np.array([6, 3, 5, 2, 6], np.int32)
    rh = rng.uniform(-80.0, 0.0, size=(S, R, H))
    for s in range(S):
        rh[s, :, n_valid[s]:] = MIN_LOG  # panel padding, as fit_calling_multi pads
    counts = rng.integers(0, 3, size=(S, R)).astype(float)
    want = jax_calling._fit_batch_pallas(
        jnp.asarray(rh), jnp.asarray(counts), ploidy, steps, chains, 4, H,
        n_valid=n_valid, burn=burn, interpret=True, mesh=None,
    )
    got = calling._fit_batch_kernel(
        rh, counts, ploidy, steps, chains, 4, n_valid, burn,
        device=torch.device("cpu"), pinned_noise=1e-12,
    )
    assert len(got) == len(want) == S
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.genotypes.shape == (chains, steps - burn, ploidy)
        np.testing.assert_array_equal(g.genotypes, w.genotypes)
        np.testing.assert_allclose(g.llks, w.llks, rtol=1e-4)
        assert g.pre_burned == w.pre_burned == burn
        assert g.n_allele == n_valid[s]
        assert g.genotypes.max() < n_valid[s]


def _trace_pair(seed, n_allele=5, chains=2, steps=60, ploidy=4):
    rng = np.random.default_rng(seed)
    modes = rng.integers(0, n_allele, size=(3, ploidy))
    pick = rng.choice(3, size=(chains, steps), p=[0.7, 0.2, 0.1])
    g = np.sort(modes[pick], axis=-1).astype(np.int8)
    llks = rng.normal(size=(chains, steps))
    return (
        calling.GenotypeAllelesMultiTrace(g, llks, n_allele),
        jax_calling.GenotypeAllelesMultiTrace(g, llks, n_allele),
    )


def _assert_same_posterior(a, b):
    np.testing.assert_array_equal(a.genotypes, b.genotypes)
    np.testing.assert_allclose(a.probabilities, b.probabilities, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_classes_match_jax(seed):
    t, j = _trace_pair(seed)
    tb, jb = t.burn(10), j.burn(10)
    np.testing.assert_array_equal(tb.genotypes, jb.genotypes)
    np.testing.assert_array_equal(tb.llks, jb.llks)
    labels = np.array([4, 0, 3, 1, 2, 5])
    tr, jr = tb.relabel(labels), jb.relabel(labels)
    np.testing.assert_array_equal(tr.genotypes, jr.genotypes)
    assert tr.n_allele == jr.n_allele
    for a, b in zip(tr.split(), jr.split()):
        np.testing.assert_array_equal(a.genotypes, b.genotypes)
    assert tr.replicate_incongruence() == jr.replicate_incongruence()
    assert tr.replicate_incongruence(0.05) == jr.replicate_incongruence(0.05)
    for x, y in zip(tr.posterior_frequencies(), jr.posterior_frequencies()):
        np.testing.assert_allclose(x, y, rtol=1e-12)
    tp, jp = tr.posterior(), jr.posterior()
    _assert_same_posterior(tp, jp)
    for x, y in zip(tp.mode(), jp.mode()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tp.mode(genotype_support=True), jp.mode(genotype_support=True)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tp.as_array(6), jp.as_array(6))


def test_pre_burned_trace_burn_matches_jax():
    t, j = _trace_pair(3)
    t = calling.GenotypeAllelesMultiTrace(t.genotypes, t.llks, 5, pre_burned=20)
    j = jax_calling.GenotypeAllelesMultiTrace(j.genotypes, j.llks, 5, pre_burned=20)
    for n in (5, 20, 30):
        np.testing.assert_array_equal(t.burn(n).genotypes, j.burn(n).genotypes)
        assert t.burn(n).pre_burned == j.burn(n).pre_burned


def _posterior(trace, n_alleles, ploidy=4):
    return trace.posterior().as_array(n_alleles)


def test_fit_calling_multi_flat_matches_exact():
    """Heterogeneous panels in one K2 batch (plain version on the CPU):
    each problem's posterior matches exact enumeration on its own panel."""
    panel_b = np.array([[0, 0], [1, 1]], dtype=np.int8)
    reads_a = simulate_reads(HAPS[[0, 0, 1, 3]], n_alleles=2, n_reads=12,
                             qual=(30, 40), seed=5)
    reads_b = simulate_reads(panel_b[[0, 1, 1, 1]], n_alleles=2, n_reads=5,
                             qual=(30, 40), seed=6)
    problems = [
        dict(reads=reads_a, counts=np.ones(len(reads_a)), haplotypes=HAPS),
        dict(reads=reads_b, counts=np.ones(len(reads_b)), haplotypes=panel_b),
    ]
    traces = calling.fit_calling_multi(problems, ploidy=4, steps=400, chains=64,
                                       random_seed=3, burn=100, device="cpu")
    assert [t.n_allele for t in traces] == [4, 2]
    for t, reads, panel in zip(traces, (reads_a, reads_b), (HAPS, panel_b)):
        assert t.genotypes.max() < len(panel)
        llks = jax_exact.genotype_likelihoods(reads, 4, panel)
        want = np.asarray(jax_exact.genotype_posteriors(llks, 4, len(panel)))
        np.testing.assert_allclose(_posterior(t, len(panel)), want, atol=0.06)


def test_fit_calling_multi_with_priors_matches_exact():
    """Per-problem inbreeding and frequency priors go through the torch
    sampler and match the exact Dirichlet-multinomial posterior."""
    reads = simulate_reads(HAPS[[0, 1, 1, 3]], n_alleles=2, n_reads=8,
                           qual=(20, 30), seed=9)
    freqs = np.array([0.4, 0.3, 0.2, 0.1])
    problems = [
        dict(reads=reads, counts=np.ones(len(reads)), haplotypes=HAPS,
             inbreeding=0.1, frequencies=freqs),
        dict(reads=reads, counts=np.ones(len(reads)), haplotypes=HAPS[:3],
             inbreeding=0.3, frequencies=freqs[:3] / freqs[:3].sum()),
    ]
    traces = calling.fit_calling_multi(problems, ploidy=4, steps=500, chains=48,
                                       random_seed=1, burn=100, device="cpu")
    llks = jax_exact.genotype_likelihoods(reads, 4, HAPS)
    want = np.asarray(
        jax_exact.genotype_posteriors(llks, 4, len(HAPS), prior=(0.1, freqs))
    )
    np.testing.assert_allclose(_posterior(traces[0], 4), want, atol=0.06)
    llks3 = jax_exact.genotype_likelihoods(reads, 4, HAPS[:3])
    want3 = np.asarray(jax_exact.genotype_posteriors(
        llks3, 4, 3, prior=(0.3, freqs[:3] / freqs[:3].sum())
    ))
    assert traces[1].genotypes.max() < 3
    np.testing.assert_allclose(_posterior(traces[1], 3), want3, atol=0.06)


def test_calling_mcmc_fit_routes():
    """CallingMCMC: flat Gibbs through K2's plain version (every slot
    starts at allele 0); Metropolis-Hastings through the torch sampler;
    the zero-variant shortcut; the MAP at high depth."""
    reads = simulate_reads(HAPS[[0, 1, 1, 2]], n_alleles=2, n_reads=60,
                           errors=False, seed=4)
    for step_type in ("Gibbs", "Metropolis-Hastings"):
        trace = calling.CallingMCMC(
            ploidy=4, haplotypes=HAPS, steps=300, chains=2, random_seed=5,
            step_type=step_type, device="cpu",
        ).fit(reads).burn(100)
        mode, prob = trace.posterior().mode()
        np.testing.assert_array_equal(mode, [0, 1, 1, 2])
        assert prob > 0.9
    zero = calling.CallingMCMC(
        ploidy=4, haplotypes=np.zeros((1, 0), np.int8), steps=50, chains=2,
        device="cpu",
    ).fit(np.empty((5, 0, 2)))
    assert zero.genotypes.shape == (2, 50, 4) and np.isnan(zero.llks).all()
    with pytest.raises(ValueError, match="step type"):
        calling.CallingMCMC(ploidy=4, haplotypes=HAPS, step_type="bogus",
                            device="cpu").fit(reads)


def test_k2_unsupported_reason():
    from mchap_tpu_torch.ops.cuda_calling import k2_unsupported_reason

    assert k2_unsupported_reason(4, 64) is None
    assert k2_unsupported_reason(8, 4096) is None
    assert "ploidy 9" in k2_unsupported_reason(9, 64)
    assert "shared memory" in k2_unsupported_reason(4, 16384)


@pytest.mark.parametrize("multi", [False, True])
def test_call_route_outside_k2(multi):
    """Ploidy 9 is outside K2: the flat Gibbs problem is sent to the torch
    sampler before any launch (K2's plain version would refuse it), from
    the block fit and from the model's one-problem ``fit``."""
    from mchap_tpu_torch.utils import fallback

    ploidy = 9
    rng = np.random.default_rng(5)
    reads = [
        simulate_reads(HAPS[rng.integers(0, len(HAPS), ploidy)], n_alleles=2,
                       n_reads=24, seed=i)
        for i in range(2)
    ]
    counts = [np.ones(len(r)) for r in reads]
    fallback.PATHS.clear()
    if multi:
        problems = [dict(reads=r, counts=c, haplotypes=HAPS) for r, c in zip(reads, counts)]
        traces = calling.fit_calling_multi(problems, ploidy, steps=20, chains=2,
                                           random_seed=3, device="cpu")
    else:
        traces = [calling.CallingMCMC(ploidy=ploidy, haplotypes=HAPS, steps=20, chains=2,
                                      random_seed=3, device="cpu").fit(reads[0], counts[0])]
    assert dict(fallback.PATHS) == {("calling", "torch"): 1}
    for t in traces:
        assert t.genotypes.shape == (2, 20, ploidy)
        assert np.isfinite(t.llks).all()


#: the traces of the one-locus batch fit (``fit_calling_batch`` at commit
#: f85a51e) on one problem, seed 5, 6 steps x 2 chains: genotypes, and
#: llks as float.hex; flat Gibbs through K2's plain version, and a
#: Dirichlet-multinomial prior through the torch sampler
PINNED = {
    "k2": (
        [[[0, 1, 2, 2], [1, 1, 2, 2], [0, 1, 2, 2], [1, 2, 2, 2], [1, 2, 2, 2], [1, 1, 1, 2]],
         [[1, 1, 2, 2], [1, 2, 2, 2], [1, 1, 2, 2], [1, 2, 2, 2], [1, 2, 2, 2], [1, 1, 1, 2]]],
        [["-0x1.66c56c0000000p+2", "-0x1.0e0c6c0000000p+2", "-0x1.66c56c0000000p+2",
          "-0x1.fdf1d00000000p+1", "-0x1.fdf1d00000000p+1", "-0x1.8b983c0000000p+2"],
         ["-0x1.0e0c6c0000000p+2", "-0x1.fdf1d00000000p+1", "-0x1.0e0c6c0000000p+2",
          "-0x1.fdf1d00000000p+1", "-0x1.fdf1d00000000p+1", "-0x1.8b983c0000000p+2"]],
    ),
    "torch": (
        [[[1, 1, 2, 2], [1, 2, 2, 2], [1, 2, 2, 2], [1, 2, 2, 2], [1, 1, 2, 2], [1, 1, 2, 2]],
         [[0, 1, 2, 2], [1, 2, 2, 2], [1, 2, 2, 3], [1, 2, 2, 3], [1, 2, 2, 2], [1, 1, 2, 3]]],
        [["-0x1.0e0c6bb1e3688p+2", "-0x1.fdf1cff59b7a8p+1", "-0x1.fdf1cff59b7a8p+1",
          "-0x1.fdf1cff59b7a8p+1", "-0x1.0e0c6bb1e3688p+2", "-0x1.0e0c6bb1e3688p+2"],
         ["-0x1.66c56baf4cff2p+2", "-0x1.fdf1cff59b7a7p+1", "-0x1.66c56bd18dbe6p+2",
          "-0x1.66c56bd18dbe6p+2", "-0x1.fdf1cff59b7a8p+1", "-0x1.bf7e759228081p+2"]],
    ),
}


@pytest.mark.parametrize("route", list(PINNED))
def test_one_problem_fit_matches_pinned_batch_fit(route):
    """``fit_calling_multi`` with one problem, and ``CallingMCMC.fit``
    through it, give the pinned traces bit for bit."""
    reads = simulate_reads(HAPS[[0, 1, 1, 2]], n_alleles=2, n_reads=6, errors=True, seed=4)
    counts = np.ones(len(reads))
    prior = None if route == "k2" else (0.1, np.array([0.1, 0.2, 0.3, 0.4]))
    problem = dict(reads=reads, counts=counts, haplotypes=HAPS)
    if prior is not None:
        problem.update(inbreeding=prior[0], frequencies=prior[1])
    multi = calling.fit_calling_multi([problem], 4, steps=6, chains=2, random_seed=5,
                                      device="cpu")[0]
    fit = calling.CallingMCMC(ploidy=4, haplotypes=HAPS, prior=prior, steps=6, chains=2,
                              random_seed=5, device="cpu").fit(reads, counts)
    genotypes, llks = PINNED[route]
    want = np.array([[float.fromhex(x) for x in row] for row in llks])
    for trace in (multi, fit):
        assert trace.genotypes.dtype == np.int8 and trace.n_allele == len(HAPS)
        np.testing.assert_array_equal(trace.genotypes, genotypes)
        np.testing.assert_array_equal(trace.llks, want)
