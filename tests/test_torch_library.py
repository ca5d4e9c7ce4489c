"""The port's library remainder against ``mchap_tpu``, on the cases of
``tests/test_numerics.py`` (combinadics 23-37, logprob 113-143) and
``tests/test_likelihood.py`` (44-114), one parametrised test each.

- combinadics: ``comb``, ``comb_with_replacement`` and the two counting
  functions equal JAX's and ``math.comb`` exactly;
- logprob: ``normalise_log_probs`` and ``logsumexp`` (with ``where``)
  equal JAX's to 1e-12; the categorical draws, made from a
  ``torch.Generator``, match their probabilities within 0.03 over 4000
  draws and never pick a zero-probability option;
- likelihood: ``log_likelihood`` and ``log_likelihood_from_read_hap``
  equal JAX's and the brute-force oracle to rel 1e-10;
- ``testing.metropolis_hastings_transitions`` and
  ``models/inheritence.py`` give JAX's arrays.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mchap_tpu
import mchap_tpu_torch
from mchap_tpu import testing as jax_testing
from mchap_tpu.models import inheritence as jax_inheritence
from mchap_tpu.numerics import combinadics as jax_comb
from mchap_tpu.numerics import logprob as jax_logprob
from mchap_tpu.ops import likelihood as jax_likelihood
from mchap_tpu_torch import testing
from mchap_tpu_torch.models import inheritence
from mchap_tpu_torch.numerics import combinadics, logprob
from mchap_tpu_torch.ops import likelihood
from test_likelihood import oracle_log_likelihood, random_reads

torch.set_num_threads(1)

COMBINADICS = (
    [("comb", k) for k in (0, 1, 2, 3, 4, 6, 8)]
    + [("comb_with_replacement", k) for k in (1, 2, 4)]
    + [("count_unique_genotype_permutations", None),
       ("count_haplotype_universial_occurance", None)]
)


@pytest.mark.parametrize("name, k", COMBINADICS)
def test_combinadics_match_jax(name, k):
    if k is None:
        for u, ploidy in [(1, 2), (3, 2), (4, 4), (7, 6), (16, 8)]:
            got = getattr(combinadics, name)(u, ploidy)
            assert got == getattr(jax_comb, name)(u, ploidy)
        return
    ns = np.arange(0, 60 if name == "comb" else 40)
    got = getattr(combinadics, name)(ns, k)
    np.testing.assert_array_equal(got, np.asarray(getattr(jax_comb, name)(ns, k)))
    if name == "comb":
        want = [math.comb(int(n), k) for n in ns]
    else:
        want = [math.comb(int(n) + k - 1, k) if (n, k) != (0, 0) else 0 for n in ns]
    np.testing.assert_array_equal(got, want)


def _draws(fn, probs, n=4000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    rows = torch.as_tensor(np.broadcast_to(probs, (n, len(probs))).copy())
    return np.bincount(fn(gen, rows).numpy(), minlength=len(probs)) / n


LOGPROB = ["normalise", "normalise_inf", "logsumexp_where", "random_choice",
           "random_choice_zero", "random_choice_log", "log10"]


@pytest.mark.parametrize("case", LOGPROB)
def test_logprob_matches_jax(case):
    probs = np.array([0.2, 0.5, 0.3])
    if case == "normalise":
        llks = np.log([0.1, 0.2, 0.4])
        got = logprob.normalise_log_probs(torch.as_tensor(llks)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_logprob.normalise_log_probs(llks)),
                                   rtol=1e-12)
        np.testing.assert_allclose(got, [1 / 7, 2 / 7, 4 / 7], rtol=1e-12)
    elif case == "normalise_inf":
        llks = np.array([-np.inf, 0.0, -np.inf])
        got = logprob.normalise_log_probs(torch.as_tensor(llks)).numpy()
        np.testing.assert_allclose(got, [0.0, 1.0, 0.0])
        np.testing.assert_allclose(got, np.asarray(jax_logprob.normalise_log_probs(llks)))
    elif case == "logsumexp_where":
        a = np.random.default_rng(3).normal(size=(4, 5))
        where = a > -0.5
        for axis in (None, 0, -1):
            np.testing.assert_allclose(
                logprob.logsumexp(torch.as_tensor(a), axis, torch.as_tensor(where)).numpy(),
                np.asarray(jax_logprob.logsumexp(a, axis, where)), rtol=1e-12)
    elif case == "random_choice":
        np.testing.assert_allclose(_draws(logprob.random_choice, probs), probs, atol=0.03)
    elif case == "random_choice_zero":
        freqs = _draws(logprob.random_choice, np.array([0.0, 1.0, 0.0]), n=500, seed=1)
        np.testing.assert_array_equal(freqs, [0.0, 1.0, 0.0])
    elif case == "random_choice_log":
        freqs = _draws(logprob.random_choice_log, np.log(probs) + 3.0)
        np.testing.assert_allclose(freqs, probs, atol=0.03)
    else:
        want = float(jax_logprob.natural_log_to_log10(jnp.log(100.0)))
        assert logprob.natural_log_to_log10(math.log(100.0)) == pytest.approx(want)


LIKELIHOOD = (["exact_small", "gaps"] + [f"fuzz{s}" for s in range(8)]
              + [f"read_hap{s}" for s in range(4)] + ["batched"])


@pytest.mark.parametrize("case", LIKELIHOOD)
def test_likelihood_matches_jax(case):
    if case in ("exact_small", "gaps"):
        second = [0.8, 0.2] if case == "exact_small" else [np.nan, np.nan]
        reads = np.array([[[0.9, 0.1], second]])
        genotype = np.array([[0, 0], [1, 1]], dtype=np.int8)
        want = np.log((0.9 * 0.8 + 0.1 * 0.2) / 2) if case == "exact_small" else np.log(0.5)
        got = float(likelihood.log_likelihood(reads, genotype))
        assert got == pytest.approx(want, rel=1e-10)
        assert got == pytest.approx(float(jax_likelihood.log_likelihood(reads, genotype)),
                                    rel=1e-12)
    elif case.startswith("fuzz"):
        rng = np.random.default_rng(int(case[4:]))
        ploidy, n_base = int(rng.integers(1, 5)), int(rng.integers(1, 12))
        n_nucl, n_reads = int(rng.integers(2, 5)), int(rng.integers(1, 20))
        reads = random_reads(rng, n_reads, n_base, n_nucl)
        genotype = rng.integers(0, n_nucl, size=(ploidy, n_base)).astype(np.int8)
        counts = rng.integers(1, 5, size=n_reads)
        for c in (counts, None):
            got = float(likelihood.log_likelihood(reads, genotype, c))
            assert got == pytest.approx(oracle_log_likelihood(reads, genotype, c), rel=1e-10)
            want = float(jax_likelihood.log_likelihood(
                reads, jnp.asarray(genotype), None if c is None else jnp.asarray(c)))
            assert got == pytest.approx(want, rel=1e-12)
    elif case.startswith("read_hap"):
        rng = np.random.default_rng(int(case[8:]) + 100)
        reads = random_reads(rng, 10, 6, 3)
        panel = rng.integers(0, 3, size=(5, 6)).astype(np.int8)
        alleles = rng.integers(0, 5, size=4)
        read_hap = likelihood.read_hap_loglik(likelihood.prepare_reads(reads), panel)
        got = float(likelihood.log_likelihood_from_read_hap(read_hap, alleles))
        assert got == pytest.approx(oracle_log_likelihood(reads, panel[alleles]), rel=1e-10)
        jrh = jax_likelihood.read_hap_loglik(jax_likelihood.prepare_reads(reads), panel)
        want = float(jax_likelihood.log_likelihood_from_read_hap(jrh, jnp.asarray(alleles)))
        assert got == pytest.approx(want, rel=1e-12)
    else:
        rng = np.random.default_rng(7)
        reads = random_reads(rng, 8, 5, 2)
        panel = rng.integers(0, 2, size=(4, 5)).astype(np.int8)
        read_hap = likelihood.read_hap_loglik(likelihood.prepare_reads(reads), panel)
        genotypes = rng.integers(0, 4, size=(10, 3))
        counts = rng.integers(1, 3, size=8).astype(float)
        got = likelihood.log_likelihood_from_read_hap(
            read_hap.expand((10,) + read_hap.shape), genotypes, counts).numpy()
        jrh = jax_likelihood.read_hap_loglik(jax_likelihood.prepare_reads(reads), panel)
        want = np.asarray(jax_likelihood.log_likelihood_from_read_hap(
            jnp.broadcast_to(jrh, (10,) + jrh.shape), jnp.asarray(genotypes), jnp.asarray(counts)))
        np.testing.assert_allclose(got, want, rtol=1e-12)
        for i in range(10):
            assert got[i] == pytest.approx(
                oracle_log_likelihood(reads, panel[genotypes[i]], counts), rel=1e-10)


def test_metropolis_hastings_transitions_match_jax():
    rng = np.random.default_rng(5)
    transitions = (rng.random((6, 6)) < 0.6).astype(float)
    np.fill_diagonal(transitions, 0)
    transitions = np.maximum(transitions, transitions.T)
    llks, priors = rng.normal(size=6), rng.uniform(0.1, 1.0, 6)
    got = testing.metropolis_hastings_transitions(transitions, llks, priors)
    want = jax_testing.metropolis_hastings_transitions(transitions, llks, priors)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-12)


@pytest.mark.parametrize("order", [None, "ascending", "descending"])
def test_inheritence_matches_jax(order):
    rng = np.random.default_rng(2)
    genotypes = rng.integers(0, 2, size=(5, 4, 3)).astype(np.int8)
    probs = rng.dirichlet(np.ones(5))
    gametes = inheritence.gamete_probabilities(genotypes, probs, order=order)
    want = jax_inheritence.gamete_probabilities(genotypes, probs, order=order)
    for g, w in zip(gametes, want):
        np.testing.assert_array_equal(g, w)
    cross = inheritence.cross_probabilities(*gametes, *gametes, order=order)
    want = jax_inheritence.cross_probabilities(*want, *want, order=order)
    for g, w in zip(cross, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(cross[1].sum(), 1.0)


def test_public_api_matches_jax():
    """The port exports mchap_tpu's public names (no JAX-only settings)."""
    assert mchap_tpu_torch.__all__ == mchap_tpu.__all__
    assert mchap_tpu_torch.DenovoMCMC.__module__ == "mchap_tpu_torch.models.assemble"
    assert mchap_tpu_torch.combinatorics is combinadics
