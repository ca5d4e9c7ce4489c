"""The one-pass PEDERR (``ops/pedigree_mcmc.trace_incongruence``) against
the per-child ``trio_valid``/``duo_valid`` loop it replaced, bit for bit.

Traces are seeded and random, drawn from a few alleles so that valid and
invalid states both occur.  Each case runs twice: with the panel's
alleles as drawn and with them spread over sparse ids of a large panel,
which the pass renumbers to the alleles the trace holds.
"""

import numpy as np
import pytest
import torch

from mchap_tpu_torch.models import pedigree
from mchap_tpu_torch.ops import pedigree_mcmc as TK
from mchap_tpu_torch.utils import timing

torch.set_num_threads(1)


def _loop_incongruence(trace, sample_parents, gamete_tau, gamete_lambda):
    """Per-child PEDERR, as ``PedigreeAllelesMultiTrace.incongruence``
    worked it out before the one-pass form."""
    n_chains, n_steps, n_samples, max_ploidy = trace.shape
    trace = trace.reshape(n_chains * n_steps, n_samples, max_ploidy)
    out = np.zeros(n_samples)
    for i in range(n_samples):
        p, q = sample_parents[i]
        progeny = trace[:, i, :]
        if p < 0 and q < 0:
            continue
        if p < 0:
            valid = TK.duo_valid(progeny, trace[:, q, :], gamete_tau[i, 1], gamete_lambda[i, 1])
        elif q < 0:
            valid = TK.duo_valid(progeny, trace[:, p, :], gamete_tau[i, 0], gamete_lambda[i, 0])
        else:
            valid = TK.trio_valid(progeny, trace[:, p, :], trace[:, q, :], gamete_tau[i, 0],
                                  gamete_tau[i, 1], gamete_lambda[i, 0], gamete_lambda[i, 1])
        out[i] = 1.0 - valid.mean()
    return out


def _trace(rng, ploidy, n_allele, chains=2, steps=60):
    """A sorted joint trace [chains, steps, S, max_ploidy], -1 padded."""
    max_ploidy = max(ploidy)
    trace = rng.integers(0, n_allele, (chains, steps, len(ploidy), max_ploidy))
    trace = np.sort(trace, axis=-1)
    for j, k in enumerate(ploidy):
        trace[:, :, j, k:] = -1
    return trace


def _check(trace, n_allele, parents, tau, lam):
    want = _loop_incongruence(trace, parents, tau, lam)
    got = pedigree.PedigreeAllelesMultiTrace(trace, n_allele).incongruence(
        None, parents, tau, lam)
    np.testing.assert_array_equal(got, want)
    assert (want[(parents < 0).all(-1)] == 0).all()
    # the same states with the alleles spread over a panel of hundreds
    spread = np.where(trace >= 0, trace * 37 + 300, -1).astype(trace.dtype)
    got = TK.trace_incongruence(spread, parents, tau, lam)
    np.testing.assert_array_equal(got, want)
    return want


# founders 0-2; a trio, duos with only p and only q known, a triploid child
# padded with -1, and a child of the triploid
PARENTS = np.array([[-1, -1], [-1, -1], [-1, -1], [0, 1], [0, -1], [-1, 1], [1, 2],
                    [6, 3]])
PLOIDY = [4, 4, 4, 4, 4, 4, 3, 4]
TAU = np.array([[2, 2]] * 6 + [[2, 1], [1, 2]])


@pytest.mark.parametrize("dtype", [np.int16, np.int64])
@pytest.mark.parametrize("lam", [(0.0, 0.0), (0.3, 0.0), (0.0, 0.3)],
                         ids=["lam0", "lam_p", "lam_q"])
@pytest.mark.parametrize("n_allele", [2, 3, 5])
def test_mixed_pedigree_matches_per_child_loop(dtype, lam, n_allele):
    rng = np.random.default_rng(n_allele * 10 + int(10 * sum(lam)) + lam.index(max(lam)))
    trace = _trace(rng, PLOIDY, n_allele).astype(dtype)
    out = _check(trace, n_allele, PARENTS, TAU, np.tile(lam, (len(PARENTS), 1)))
    if n_allele == 3:
        assert 0 < out[3:].min() and out[3:].max() < 1  # both outcomes occur


@pytest.mark.parametrize("tau_pair", [(2, 2), (1, 3), (3, 3)])
@pytest.mark.parametrize("lam", [0.0, 0.2])
def test_hexaploid_tau_pairs_match_per_child_loop(tau_pair, lam):
    rng = np.random.default_rng(sum(tau_pair) + int(10 * lam))
    parents = np.array([[-1, -1], [-1, -1], [0, 1], [1, 0], [0, -1], [-1, 1], [0, 0]])
    tau = np.tile(tau_pair, (len(parents), 1))
    lams = np.array([[lam, 0.0]] * len(parents))
    _check(_trace(rng, [6] * len(parents), 4), 4, parents, tau, lams)


def test_trace_burned_to_one_state():
    rng = np.random.default_rng(7)
    trace = _trace(rng, PLOIDY, 3, chains=1, steps=40)
    got = pedigree.PedigreeAllelesMultiTrace(trace, 3).burn(39)
    assert got.genotypes.shape[:2] == (1, 1)
    out = _check(got.genotypes, 3, PARENTS, TAU, np.zeros((len(PARENTS), 2)))
    assert set(out) <= {0.0, 1.0}


def test_founders_only_and_the_counter(monkeypatch):
    """No child: all zeros and nothing judged.  With children, the
    counter adds kept states x judged samples per pass."""
    monkeypatch.setenv("MCHAP_TIMING", "1")
    monkeypatch.delenv("MCHAP_TRACE", raising=False)
    timers = timing.reset()
    try:
        trace = _trace(np.random.default_rng(1), [4, 4], 3)
        founders = np.full((2, 2), -1)
        out = TK.trace_incongruence(trace, founders, np.full((2, 2), 2), np.zeros((2, 2)))
        np.testing.assert_array_equal(out, [0.0, 0.0])
        assert "pedigree.incongruence_checks" not in timers.counters
        trace = _trace(np.random.default_rng(2), PLOIDY, 3)
        for _ in range(2):
            TK.trace_incongruence(trace, PARENTS, TAU, np.zeros((len(PARENTS), 2)))
        assert timers.counters["pedigree.incongruence_checks"] == 2 * (2 * 60) * 5
    finally:
        monkeypatch.delenv("MCHAP_TIMING")
        timing.reset()
