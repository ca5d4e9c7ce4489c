"""The calling path's numerics: K2's plain version, priors, the torch sampler.

- ``calling_sampler_plain`` (the plain version of the CUDA calling kernel,
  K2) with every uniform pinned at 1e-12 against
  ``pallas_calling_sampler(interpret=True)``, whose interpreter PRNG gives
  1e-12 for every draw: alleles identical, llks within 1e-4 relative
  (both add in f32, in different orders and from different anchors).
- The plain version with its ``torch.Generator`` stream against exact
  enumeration (total variation < 0.05).
- The anchor case: a read far below every real haplotype of a 3-allele
  panel makes the TPU kernel pick a padding allele; the port does not.
- ``ops/priors`` against ``mchap_tpu.ops.priors`` (1e-10, f64) and the
  torch ``greedy_caller`` / ``calling_sampler`` against JAX's and
  against exact posteriors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mchap_tpu.numerics import combinadics as jax_combinadics
from mchap_tpu.numerics import dosage as jax_dosage
from mchap_tpu.ops import calling_mcmc as jax_mcmc
from mchap_tpu.ops import exact as jax_exact
from mchap_tpu.ops import priors as jax_priors
from mchap_tpu.ops.pallas_calling import pallas_calling_sampler
from mchap_tpu.testing import simulate_reads
from mchap_tpu_torch.numerics import combinadics, dosage
from mchap_tpu_torch.ops import calling_mcmc, priors
from mchap_tpu_torch.ops.cuda_calling import calling_sampler, calling_sampler_plain
from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)

HAPS = np.array(
    [[0, 0, 0, 0], [0, 0, 1, 1], [1, 1, 0, 0], [1, 1, 1, 1]], dtype=np.int8
)
C = 128  # the JAX kernel's lane tile


def _rh(reads, panel):
    return read_hap_loglik(prepare_reads(reads), panel).numpy()


def _compare_with_pallas(rh, counts, n_valid, P, steps, seed=3):
    """rh [S, R, H], counts [S, R], n_valid [S]; chains c -> problem c % S.
    Returns the port's alleles [T, P, C] after asserting agreement."""
    S, R, H = rh.shape
    prob = np.arange(C) % S
    rh32 = rh.astype(np.float32)
    want_g, want_l = pallas_calling_sampler(
        jnp.int32(seed),
        jnp.asarray(np.ascontiguousarray(rh32[prob].transpose(1, 2, 0))),
        jnp.asarray(np.ascontiguousarray(counts[prob].T), jnp.float32),
        n_steps=steps, ploidy=P, n_valid=jnp.asarray(n_valid[prob]),
        interpret=True,
    )
    got_g, got_l = calling_sampler(
        torch.from_numpy(rh32), torch.from_numpy(counts.astype(np.float32)),
        torch.from_numpy(n_valid.astype(np.int32)),
        torch.from_numpy(prob.astype(np.int32)), n_steps=steps, ploidy=P,
        noise=torch.full((steps, P, H, C), 1e-12),
    )
    np.testing.assert_array_equal(got_g.numpy().astype(np.int64), np.asarray(want_g))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4)
    return got_g.numpy()


def test_k2_plain_matches_pallas_map():
    """The case of test_pallas_calling.py: pinned draws make the chain a
    greedy argmax that settles on the exact MAP genotype."""
    reads = simulate_reads(HAPS[[0, 0, 1, 3]], n_alleles=2, n_reads=40,
                           errors=False, seed=2)
    rh = _rh(reads, HAPS)[None]
    g = _compare_with_pallas(rh, np.ones((1, rh.shape[1])), np.array([4]), 4, 8)
    llks = jax_exact.genotype_likelihoods(reads, 4, HAPS)
    post = np.asarray(jax_exact.genotype_posteriors(llks, 4, len(HAPS)))
    want = jax_combinadics.index_as_genotype_alleles_np(int(np.argmax(post)), 4)
    np.testing.assert_array_equal(g[-1][:, 0], want)


def test_k2_plain_matches_pallas_three_allele_panel():
    panel = HAPS[:3]
    reads = simulate_reads(panel[[0, 1, 1, 2]], n_alleles=2, n_reads=30,
                           errors=False, seed=5)
    rh = _rh(reads, panel)[None]
    g = _compare_with_pallas(rh, np.ones((1, rh.shape[1])), np.array([3]), 4, 6)
    assert g.max() < 3


def test_k2_plain_matches_pallas_per_problem_n_valid():
    reads = simulate_reads(HAPS[[1, 1, 3, 3]], n_alleles=2, n_reads=30,
                           errors=False, seed=7)
    rh = np.repeat(_rh(reads, HAPS)[None], 2, axis=0)
    g = _compare_with_pallas(rh, np.ones(rh.shape[:2]), np.array([4, 2]), 4, 6)
    assert g[:, :, 1::2].max() < 2
    assert g[-1, :, 0::2].max() == 3


@pytest.mark.parametrize("R", [16, 40])
@pytest.mark.parametrize("H", [3, 8, 11])
@pytest.mark.parametrize("P", [2, 4])
def test_k2_plain_matches_pallas_random(P, H, R):
    rng = np.random.default_rng(100 * P + 10 * H + R)
    S = 4
    rh = rng.uniform(-30.0, 0.0, size=(S, R, H))
    counts = rng.integers(1, 4, size=(S, R)).astype(float)
    n_valid = np.array([H, max(H - 1, 1), H, max(H - 2, 1)])
    _compare_with_pallas(rh, counts, n_valid, P, 6 + P // 2)


def test_k2_plain_matches_exact_posterior():
    """The problem of scripts/gate_pallas_calling.py, sampled with the
    plain version's own stream: TV < 0.05 against exact enumeration."""
    P = 4
    panel = np.array([[0, 0, 0], [0, 1, 1], [1, 1, 0], [1, 1, 1]], np.int8)
    reads = simulate_reads(panel[[0, 1, 1, 3]], n_alleles=2, n_reads=8,
                           errors=False, uniform_sample=True, qual=(20, 20), seed=7)
    llks = jax_exact.genotype_likelihoods(reads, P, panel)
    want = np.asarray(jax_exact.genotype_posteriors(llks, P, len(panel)))
    chains, steps, burn = 512, 300, 50
    rh = torch.from_numpy(_rh(reads, panel).astype(np.float32))[None]
    g, _ = calling_sampler_plain(
        rh, torch.ones((1, rh.shape[1])), torch.tensor([len(panel)], dtype=torch.int32),
        torch.zeros(chains, dtype=torch.int32), n_steps=steps, ploidy=P, seed=13,
    )
    flat = g[burn:].permute(0, 2, 1).reshape(-1, P).numpy().astype(np.int64)
    idx = combinadics.genotype_alleles_as_index(flat)
    got = np.bincount(idx, minlength=len(want)) / len(idx)
    assert 0.5 * np.abs(got - want).sum() < 0.05


def test_k2_anchor_takes_valid_alleles_only():
    """H = 3 and one read at about -125 against every haplotype: the TPU
    kernel's anchor (0, from its padding columns) underflows every real
    candidate, so it picks a padding allele; the port's anchor is the
    maximum over valid alleles, so it returns a real genotype whose llk
    matches an f64 recompute."""
    rng = np.random.default_rng(0)
    R, H, P, steps = 6, 3, 4, 3
    rh = rng.uniform(-5.0, 0.0, size=(1, R, H))
    rh[0, 0] = rng.uniform(-130.0, -120.0, size=H)
    counts = np.ones((1, R))
    prob = np.zeros(C, np.int32)
    want_g, _ = pallas_calling_sampler(
        jnp.int32(0), jnp.asarray(rh[0, :, :, None].repeat(C, 2), jnp.float32),
        jnp.ones((R, C), jnp.float32), n_steps=steps, ploidy=P, interpret=True,
    )
    assert np.asarray(want_g).max() >= H  # the reference fault, reproduced
    g, llk = calling_sampler(
        torch.from_numpy(rh.astype(np.float32)), torch.ones((1, R)),
        torch.tensor([H], dtype=torch.int32), torch.from_numpy(prob),
        n_steps=steps, ploidy=P, noise=torch.full((steps, P, H, C), 1e-12),
    )
    assert int(g.max()) < H
    assert np.isfinite(llk.numpy()).all()
    rh32 = rh[0].astype(np.float32).astype(np.float64)
    for t in range(steps):
        geno = g[t, :, 0].long().numpy()
        want = np.sum(counts[0] * (
            np.log(np.exp(rh32[:, geno]).sum(axis=1)) - np.log(P)
        ))
        assert llk[t, 0].item() == pytest.approx(want, rel=1e-3)


def _k2_args(**change):
    S, R, H, C_ = 2, 5, 3, 4
    args = dict(
        rh=torch.zeros((S, R, H)), counts=torch.ones((S, R)),
        n_valid=torch.full((S,), H, dtype=torch.int32),
        problem=torch.zeros(C_, dtype=torch.int32), n_steps=2, ploidy=2,
    )
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change",
    [
        dict(rh=torch.zeros((2, 5, 3), dtype=torch.float64)),
        dict(counts=torch.ones((2, 4))),
        dict(rh=torch.zeros((2, 3, 5)).transpose(1, 2)),
        dict(ploidy=9),
        dict(n_valid=torch.tensor([3, 0], dtype=torch.int32)),
        dict(problem=torch.tensor([0, 1, 2, 0], dtype=torch.int32)),
        dict(noise=torch.full((2, 2, 3, 5), 0.5)),
    ],
    ids=["dtype", "shape", "contiguity", "ploidy", "n_valid", "problem", "noise"],
)
def test_k2_wrapper_rejects_bad_inputs(change):
    calling_sampler(**_k2_args())  # the unchanged arguments run
    with pytest.raises(ValueError):
        calling_sampler(**_k2_args(**change))


# ---------------------------------------------------------------------------
# dosage, combinadics and priors against mchap_tpu
# ---------------------------------------------------------------------------

GENOTYPES = [[0, 0, 0, 0], [0, 0, 1, 2], [0, 1, 2, 3], [0, 2, 2, 5], [2, 0, 1, 1]]


def test_dosage_functions_match_jax():
    g = np.array(GENOTYPES)
    np.testing.assert_array_equal(
        dosage.allelic_dosage(torch.from_numpy(g)).numpy(),
        np.asarray(jax_dosage.allelic_dosage(jnp.asarray(g))),
    )
    np.testing.assert_array_equal(
        dosage.count_allele(torch.from_numpy(g), torch.tensor([0, 0, 3, 2, 1])).numpy(),
        np.asarray(jax_dosage.count_allele(jnp.asarray(g), jnp.array([0, 0, 3, 2, 1]))),
    )
    d = np.array(jax_dosage.allelic_dosage(jnp.asarray(g)))
    np.testing.assert_allclose(
        dosage.ln_equivalent_permutations(torch.from_numpy(d)).numpy(),
        np.asarray(jax_dosage.ln_equivalent_permutations(jnp.asarray(d))),
        rtol=1e-12,
    )
    haps = np.random.default_rng(1).integers(0, 2, size=(6, 4, 3))
    haps[:, 2] = haps[:, 0]
    np.testing.assert_array_equal(
        dosage.haplotype_dosage(torch.from_numpy(haps)).numpy(),
        np.asarray(jax_dosage.haplotype_dosage(jnp.asarray(haps))),
    )


@pytest.mark.parametrize("ploidy", [2, 4, 6])
def test_combinadics_match_jax(ploidy):
    for index in range(-1, 60, 7):
        np.testing.assert_array_equal(
            combinadics.index_as_genotype_alleles_np(index, ploidy),
            jax_combinadics.index_as_genotype_alleles_np(index, ploidy),
        )
    assert combinadics.count_unique_haplotypes([2, 3, 2]) == (
        jax_combinadics.count_unique_haplotypes([2, 3, 2])
    )
    for d in ([4, 0, 0], [2, 1, 1], [1, 1, 1, 1, 2][:ploidy]):
        assert combinadics.count_genotype_permutations(d) == (
            jax_combinadics.count_genotype_permutations(np.array(d))
        )


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("inbreeding", [0.0, 0.1, 0.25, 0.5])
def test_dosage_priors_match_jax(inbreeding):
    g = np.array(GENOTYPES)
    d = np.array(jax_dosage.allelic_dosage(jnp.asarray(g)))
    log_u = np.log(16.0)
    _close(
        priors.log_genotype_prior_dosage(torch.from_numpy(d), log_u, inbreeding),
        jax_priors.log_genotype_prior_dosage(jnp.asarray(d), log_u, inbreeding),
    )
    _close(
        priors.log_genotype_null_prior(torch.from_numpy(d), log_u),
        jax_priors.log_genotype_null_prior(jnp.asarray(d), log_u),
    )
    if inbreeding > 0:
        log_disp = np.log((1 - inbreeding) / inbreeding) - log_u
        _close(
            priors.log_dirichlet_multinomial_pmf(torch.from_numpy(d), log_disp, log_u),
            jax_priors.log_dirichlet_multinomial_pmf(jnp.asarray(d), log_disp, log_u),
        )
        _close(
            priors.calculate_alphas(inbreeding, torch.tensor([0.4, 0.6], dtype=torch.float64)),
            jax_priors.calculate_alphas(inbreeding, jnp.array([0.4, 0.6])),
        )


@pytest.mark.parametrize("freqs", [None, [0.3, 0.2, 0.1, 0.1, 0.1, 0.2]])
@pytest.mark.parametrize("inbreeding", [0.0, 0.1, 0.4])
def test_calling_priors_match_jax(inbreeding, freqs):
    n_alleles = 6
    g = np.array(GENOTYPES)
    f_t = None if freqs is None else torch.tensor(freqs, dtype=torch.float64)
    f_j = None if freqs is None else jnp.asarray(freqs)
    _close(
        priors.log_genotype_prior(torch.from_numpy(g), n_alleles, inbreeding, f_t),
        jax_priors.log_genotype_prior(jnp.asarray(g), n_alleles, inbreeding, f_j),
    )
    for slot in range(4):
        _close(
            priors.log_genotype_allele_prior(
                torch.from_numpy(g), torch.tensor(slot), n_alleles, inbreeding, f_t
            ),
            jax_priors.log_genotype_allele_prior(
                jnp.asarray(g), jnp.full(len(g), slot), n_alleles, inbreeding, f_j
            ),
        )
        _close(
            priors.log_genotype_allele_flat_prior(torch.from_numpy(g), torch.tensor(slot)),
            jax_priors.log_genotype_allele_flat_prior(jnp.asarray(g), jnp.full(len(g), slot)),
        )


# ---------------------------------------------------------------------------
# the torch sampler (--use-dirmul-prior, Metropolis-Hastings)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_n_valid", [False, True])
@pytest.mark.parametrize("prior", [None, (0.2, [0.4, 0.3, 0.2, 0.1, 0.0])])
def test_greedy_caller_matches_jax(prior, use_n_valid):
    rng = np.random.default_rng(5)
    S, R, H, P = 6, 12, 5, 4
    rh = rng.uniform(-12.0, 0.0, size=(S, R, H))
    counts = rng.integers(1, 4, size=(S, R)).astype(float)
    n_valid = np.array([5, 4, 3, 5, 2, 4]) if use_n_valid else None
    kind = 0 if prior is None else 1
    inbreeding = 0.0 if prior is None else prior[0]
    freqs = None if prior is None else np.asarray(prior[1])
    got = calling_mcmc.greedy_caller(
        torch.from_numpy(rh), torch.from_numpy(counts), ploidy=P, prior_kind=kind,
        inbreeding=inbreeding,
        frequencies=None if freqs is None else torch.from_numpy(freqs).expand(S, H),
        n_valid=None if n_valid is None else torch.from_numpy(n_valid),
    ).numpy()
    for s in range(S):
        want = jax_mcmc.greedy_caller(
            jnp.asarray(rh[s]), jnp.asarray(counts[s]), ploidy=P, prior_kind=kind,
            inbreeding=inbreeding, frequencies=None if freqs is None else jnp.asarray(freqs),
            n_valid=None if n_valid is None else int(n_valid[s]),
        )
        np.testing.assert_array_equal(got[s], np.asarray(want))


@pytest.mark.parametrize("step_type", [0, 1])
@pytest.mark.parametrize("prior", [None, (0.1, np.array([0.4, 0.3, 0.2, 0.1]))])
def test_torch_sampler_matches_exact_posterior(step_type, prior):
    reads = simulate_reads(HAPS[[0, 0, 1, 3]], n_alleles=2, n_reads=8,
                           qual=(20, 30), seed=3)
    rh = torch.from_numpy(_rh(reads, HAPS))[None]
    kind = 0 if prior is None else 1
    chains, steps, burn = 64, 500, 100
    gen = torch.Generator()
    gen.manual_seed(7)
    g, _ = calling_mcmc.calling_sampler(
        gen, torch.zeros((1, chains, 4), dtype=torch.long), rh,
        torch.ones((1, rh.shape[1]), dtype=torch.float64), n_steps=steps,
        step_type=step_type, prior_kind=kind,
        inbreeding=0.0 if prior is None else prior[0],
        frequencies=None if prior is None else torch.from_numpy(prior[1])[None],
    )
    idx = combinadics.genotype_alleles_as_index(g[0, :, burn:].reshape(-1, 4).numpy())
    got = np.bincount(idx, minlength=35) / len(idx)
    llks = jax_exact.genotype_likelihoods(reads, 4, HAPS)
    want = np.asarray(jax_exact.genotype_posteriors(llks, 4, len(HAPS), prior=prior))
    np.testing.assert_allclose(got, want, atol=0.05)
