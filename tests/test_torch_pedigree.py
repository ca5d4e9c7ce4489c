"""The port's pedigree model against mchap_tpu's, on the CPU.

- the trio pmf (lambda 0 and > 0, missing parents, clone edges, selfing)
  and the host helpers equal the JAX package's; K3's linear trio pmf
  equals the log-domain one at lambda 0;
- the exact pedigree oracle equals the JAX package's;
- the torch joint sampler and K3's plain version match exact enumeration;
- the model routes and the trace methods.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mchap_tpu.models import pedigree as jax_pedigree
from mchap_tpu.ops import pedigree_mcmc as JK
from mchap_tpu.testing import exact_pedigree_marginals as jax_exact_marginals
from mchap_tpu_torch.models import pedigree
from mchap_tpu_torch.numerics.combinadics import enumerate_genotypes
from mchap_tpu_torch.ops import cuda_pedigree as K3
from mchap_tpu_torch.ops import exact
from mchap_tpu_torch.ops import pedigree_mcmc as TK
from mchap_tpu_torch.testing import exact_pedigree_marginals, simulate_reads
from mchap_tpu_torch.utils import fallback

torch.set_num_threads(1)

HAPS = np.array([[0, 0], [0, 1], [1, 1]], dtype=np.int8)
TRIO = np.array([[-1, -1], [-1, -1], [0, 1]])


def _pad(vec, maxp):
    out = np.full(maxp, -1, np.int64)
    out[: len(vec)] = vec
    return out


def _both_trios(progeny, parent_p, parent_q, ploidy_p, ploidy_q, tau, lam, err, log_freqs):
    """Both packages' trio pmf of every progeny row [n, maxp]."""
    import jax

    maxp = progeny.shape[-1]
    tables, valid = JK.composition_tables(maxp)
    want = np.asarray(jax.vmap(lambda prog: JK.trio_log_pmf(
        prog, jnp.asarray(parent_p), jnp.asarray(parent_q),
        jnp.asarray(ploidy_p), jnp.asarray(ploidy_q), jnp.asarray(tau[0]),
        jnp.asarray(tau[1]), jnp.asarray(lam[0]), jnp.asarray(lam[1]),
        jnp.asarray(err[0]), jnp.asarray(err[1]), jnp.asarray(log_freqs),
        jnp.asarray(tables), jnp.asarray(valid), jnp.asarray(JK._COMB_LUT),
    ))(jnp.asarray(progeny)))
    t = torch.as_tensor
    tables, valid = TK.composition_tables(maxp)
    got = TK.trio_log_pmf(
        t(progeny), t(parent_p), t(parent_q), ploidy_p, ploidy_q, tau[0], tau[1],
        lam[0], lam[1], err[0], err[1], t(np.asarray(log_freqs, float)),
        t(tables).long(), t(valid), t(TK._COMB_LUT),
    ).numpy()
    return got, want


# reference gamete pmf value table (tests/test_pedigree_mcmc.py:27-57)
@pytest.mark.parametrize(
    "parent_dosage, parent_ploidy, gamete_dosage, gamete_ploidy, lambda_, expect",
    [
        ([2, 0], 2, [1, 0], 1, 0.0, 1.0),
        ([1, 1], 2, [1, 0], 1, 0.0, 0.5),
        ([0, 2], 2, [1, 0], 1, 0.0, 0.0),
        ([1, 1], 2, [1, 1], 2, 0.0, 1.0),
        ([1, 1], 2, [1, 1], 2, 0.2, 0.8),
        ([1, 1], 2, [0, 2], 2, 0.5, 0.25),
        ([4, 0, 0, 0], 4, [2, 0, 0, 0], 2, 0.0, 1.0),
        ([0, 1, 3, 0], 4, [0, 0, 2, 0], 2, 0.0, 0.5),
        ([0, 2, 2, 0], 4, [0, 1, 1, 0], 2, 0.0, 8 / 12),
        ([0, 2, 0, 1], 4, [0, 1, 1, 0], 2, 0.0, 0.0),
        ([2, 0, 0, 0], 4, [2, 0, 0, 0], 2, 0.5, (2 / 12 + 0.5 * 4 / 12)),
        ([1, 3, 0, 0], 4, [0, 2, 0, 0], 2, 0.5, (6 / 12 + 0.5 * 3 / 12)),
        ([1, 1, 1, 1, 1, 1], 6, [0, 0, 0, 1, 1, 1], 3, 0.0, 6 / 120),
        ([2, 2, 1, 1, 0, 0], 6, [2, 1, 0, 0, 0, 0], 3, 0.0, 12 / 120),
    ],
)
def test_gamete_log_pmf_values(parent_dosage, parent_ploidy, gamete_dosage,
                               gamete_ploidy, lambda_, expect):
    got = TK._gamete_log_pmf(
        torch.tensor([gamete_dosage]), torch.tensor(gamete_ploidy),
        torch.tensor(parent_dosage), torch.tensor(parent_ploidy),
        torch.tensor(lambda_, dtype=torch.float64), torch.as_tensor(TK._COMB_LUT),
    )
    np.testing.assert_almost_equal(np.exp(float(got[0])), expect)
    want = JK._gamete_log_pmf(
        jnp.asarray([gamete_dosage]), jnp.asarray(gamete_ploidy),
        jnp.asarray(parent_dosage), jnp.asarray(parent_ploidy),
        jnp.asarray(lambda_), jnp.asarray(JK._COMB_LUT),
    )
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-12)


# the parametrisation of tests/test_pedigree_mcmc.py:27-95, plus
# missing parents, clone edges and a selfed trio
@pytest.mark.parametrize("tau_p,tau_q,lams", [
    ((2, 2) + ((0.0, 0.0),)), ((2, 2) + ((0.2, 0.0),)), ((1, 3) + ((0.0, 0.0),)),
    ((0, 4) + ((0.0, 0.0),)),
])  # lambda > 0 needs a diploid gamete
@pytest.mark.parametrize("errs", [(0.0, 0.0), (0.01, 0.01), (1.0, 0.5)])
@pytest.mark.parametrize("parents", ["both", "p missing", "selfed"])
def test_trio_log_pmf_matches_jax(tau_p, tau_q, lams, errs, parents):
    maxp = 4
    rng = np.random.default_rng(tau_p + 10 * int(100 * errs[0]))
    parent_p = _pad(rng.integers(0, 3, 4), maxp)
    parent_q = _pad(rng.integers(0, 3, 4), maxp)
    ploidy_p = 4
    err = list(errs)
    if parents == "p missing":
        parent_p, ploidy_p, err[0] = np.full(maxp, -1), 0, 1.0
    elif parents == "selfed":
        parent_q = parent_p
    log_freqs = np.log([0.5, 0.3, 0.2])
    progeny = np.asarray(enumerate_genotypes(3, maxp), np.int64)
    got, want = _both_trios(progeny, parent_p, parent_q, ploidy_p, 4,
                            (tau_p, tau_q), lams, err, log_freqs)
    impossible = want < -1e200
    np.testing.assert_array_equal(got < -1e200, impossible)
    np.testing.assert_allclose(got[~impossible], want[~impossible], rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", range(4))
def test_k3_linear_trio_equals_log_domain(case):
    """K3's linear four-branch trio pmf (host weights) equals trio_log_pmf
    at lambda 0: two parents, one parent, a clone edge, and a triploid
    child of tetraploid parents."""
    P, tau, has_p = [(4, (2, 2), True), (4, (2, 2), False), (4, (0, 4), True),
                     (3, (2, 1), True)][case]
    rng = np.random.default_rng(case)
    t = torch.as_tensor
    freqs = rng.dirichlet(np.ones(5))
    prog = t(rng.integers(0, 5, (64, P)))
    rp, rq = t(rng.integers(0, 5, (64, 4))), t(rng.integers(0, 5, (64, 4)))
    padded = torch.cat([prog, torch.full((64, 4 - P), -1)], 1)
    tables, valid = TK.composition_tables(4)
    for err in ((0.01, 0.2), (0.0, 0.0), (1.0, 0.3), (0.5, 1.0)):
        w = K3.trio_weights(P, has_p, True, tau[0], tau[1], err[0], err[1], 4, 4)
        got = K3.trio_log_lin(prog, rp if has_p else None, rq, t(freqs), tau[0], tau[1], w)
        want = TK.trio_log_pmf(
            padded, rp if has_p else torch.full((64, 4), -1), rq, 4 if has_p else 0, 4,
            tau[0], tau[1], 0.0, 0.0, err[0] if has_p else 1.0, err[1],
            t(np.log(freqs)), t(tables).long(), t(valid), t(TK._COMB_LUT),
        )
        # an error rate of 0 floors the log-domain error branches at
        # log(1e-300); the linear form scores them exactly 0 (-1e300)
        impossible = want < -600
        assert bool((got[impossible] < -1e200).all())
        np.testing.assert_allclose(got[~impossible], want[~impossible], rtol=1e-12)


@pytest.mark.parametrize(
    "parents", [TRIO, np.array([[-1, -1], [0, 0], [-1, -1], [0, 2]]),
                np.array([[-1, -1], [-1, -1], [0, 1], [0, 2], [2, -1]])],
    ids=["trio", "selfed", "backcross"],
)
def test_pedigree_helpers_match_jax(parents):
    assert TK.chromatic_colors(parents) == JK.chromatic_colors(parents)
    children = TK.sample_children_matrix(parents)
    np.testing.assert_array_equal(children, JK.sample_children_matrix(parents))
    for a, b in zip(TK.parental_pair_markov_blankets(parents, children),
                    JK.parental_pair_markov_blankets(parents, children)):
        np.testing.assert_array_equal(a, b)
    tables, valid = TK.composition_tables(4)
    want_tables, want_valid = JK.composition_tables(4)
    np.testing.assert_array_equal(tables, want_tables)
    np.testing.assert_array_equal(valid, want_valid)


def test_validators_match_jax():
    rng = np.random.default_rng(3)
    progeny, pp, pq = (rng.integers(0, 3, (200, 4)) for _ in range(3))
    for lam in (0.0, 0.5):
        np.testing.assert_array_equal(TK.duo_valid(progeny, pp, 2, lam),
                                      JK.duo_valid(progeny, pp, 2, lam))
        for tau in ((2, 2), (1, 3)):
            np.testing.assert_array_equal(
                TK.trio_valid(progeny, pp, pq, *tau, lam, 0.0),
                JK.trio_valid(progeny, pp, pq, *tau, lam, 0.0),
            )


def _trio_reads(ploidy=2, seed=0):
    rng = np.random.default_rng(seed)
    truths = [HAPS[rng.integers(0, 3, ploidy)] for _ in range(3)]
    reads = [simulate_reads(t, n_alleles=2, n_reads=4, qual=(14, 18), seed=i)
             for i, t in enumerate(truths)]
    sample_reads = np.full((3, 4, 2, 2), np.nan)
    for i, r in enumerate(reads):
        sample_reads[i, : len(r)] = r
    llks = np.stack([exact.genotype_likelihoods(r, ploidy, HAPS).numpy() for r in reads])
    return sample_reads, np.ones((3, 4)), llks


@pytest.mark.parametrize("ploidy,tau_child,lam", [(2, (1, 1), 0.0), (4, (3, 1), 0.0),
                                                   (4, (2, 2), 0.1)])
def test_exact_pedigree_marginals_match_jax(ploidy, tau_child, lam):
    _, _, llks = _trio_reads(ploidy)
    tau = np.full((3, 2), ploidy // 2)
    tau[2] = tau_child
    args = (llks, TRIO, tau, np.full((3, 2), lam), np.full((3, 2), 0.01), 3, ploidy)
    np.testing.assert_allclose(exact_pedigree_marginals(*args),
                               jax_exact_marginals(*args), rtol=0, atol=1e-12)


# the regime of tests/test_pedigree_mcmc.py:175-220 (same atol), with many
# short chains in place of two long ones
@pytest.mark.parametrize("step_type", ["Gibbs", "Metropolis-Hastings"])
@pytest.mark.parametrize("swap", [True, False])
def test_torch_sampler_matches_exact(step_type, swap):
    sample_reads, counts, llks = _trio_reads(seed=1)
    tau, lam, err = np.ones((3, 2), int), np.zeros((3, 2)), np.full((3, 2), 0.01)
    want = exact_pedigree_marginals(llks, TRIO, tau, lam, err, 3, 2)
    rh = torch.stack([
        TK_read_hap(sample_reads[i]) for i in range(3)
    ])[None]
    ped = TK.Pedigree(np.full(3, 2), TRIO, tau, lam, err, torch.device("cpu"))
    gen = torch.Generator()
    gen.manual_seed(5)
    trace = TK.pedigree_sampler(
        gen, torch.zeros((96, 3, 2), dtype=torch.long), rh, torch.as_tensor(counts)[None],
        torch.log(torch.full((1, 3), 1 / 3, dtype=torch.float64)), torch.tensor([3]),
        torch.zeros(96, dtype=torch.long), ped, n_steps=100,
        step_type=0 if step_type == "Gibbs" else 1, swap_parental_alleles=swap,
    )
    t = pedigree.PedigreeAllelesMultiTrace(
        pedigree._sort_roll_trace(trace.numpy(), np.full(3, 2), 2), n_allele=3
    ).burn(20)
    for i in range(3):
        got = t.individual(i).posterior().as_array(3)
        np.testing.assert_allclose(got, want[i], atol=0.05)


def TK_read_hap(reads):
    from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik

    return read_hap_loglik(prepare_reads(reads), HAPS)


@pytest.mark.parametrize("selfed", [False, True])
def test_k3_plain_matches_exact(selfed):
    """K3's plain version with its own torch.Generator stream: the diploid
    trio, and a selfed trio (child of (0, 0)), against exact enumeration."""
    sample_reads, counts, llks = _trio_reads(seed=2)
    parents = np.array([[-1, -1], [-1, -1], [0, 0]]) if selfed else TRIO
    tau, lam, err = np.ones((3, 2), int), np.zeros((3, 2)), np.full((3, 2), 0.01)
    want = exact_pedigree_marginals(llks, parents, tau, lam, err, 3, 2)
    fallback.PATHS.clear()
    trace = pedigree.PedigreeCallingMCMC(
        np.full(3, 2), parents, tau, lam, err, HAPS, steps=150, chains=96,
        random_seed=4, device="cpu",
    ).fit(sample_reads, counts).burn(30)
    assert fallback.PATHS == {("pedigree", "plain"): 1}
    for i in range(3):
        got = trace.individual(i).posterior().as_array(3)
        np.testing.assert_allclose(got, want[i], atol=0.05)


@pytest.mark.parametrize("kwargs,route", [
    ({}, "plain"),
    ({"gamete_lambda": np.full((3, 2), 0.1)}, "torch"),
    ({"step_type": "Metropolis-Hastings"}, "torch"),
    ({"gamete_tau": np.array([[1, 1], [1, 1], [2, 1]])}, "torch"),
])
def test_fit_pedigree_multi_routes(kwargs, route):
    sample_reads, counts, _ = _trio_reads(seed=3)
    problems = [dict(sample_reads=sample_reads, sample_read_counts=counts,
                     haplotypes=HAPS[:h]) for h in (3, 2)]
    args = dict(sample_ploidy=np.full(3, 2), sample_parents=TRIO,
                gamete_tau=np.ones((3, 2), int), gamete_lambda=np.zeros((3, 2)),
                gamete_error=np.full((3, 2), 0.01))
    args.update(kwargs)
    fallback.PATHS.clear()
    traces = pedigree.fit_pedigree_multi(problems, steps=12, chains=3, burn=4,
                                         random_seed=1, device="cpu", **args)
    assert dict(fallback.PATHS) == {("pedigree", route): 1}
    assert [t.n_allele for t in traces] == [3, 2]
    assert traces[0].genotypes.shape == (3, 8, 3, 2)
    assert traces[1].genotypes.max() < 2


def test_trace_methods_match_jax():
    rng = np.random.default_rng(0)
    trace = np.sort(rng.integers(0, 3, (2, 20, 4, 4)), axis=-1).astype(np.int16)
    trace[:, :, 3, 3] = -1  # a triploid sample, padding rolled to the end
    trace[:, :, 3, :3] = np.sort(trace[:, :, 3, :3], axis=-1)
    parents = np.array([[-1, -1], [-1, -1], [0, 1], [0, -1]])
    tau = np.array([[2, 2], [2, 2], [2, 2], [2, 1]])
    for lam in (0.0, 0.3):
        lams = np.full((4, 2), lam)
        got = pedigree.PedigreeAllelesMultiTrace(trace, 3).burn(5)
        want = jax_pedigree.PedigreeAllelesMultiTrace(trace, 3).burn(5)
        np.testing.assert_array_equal(got.genotypes, want.genotypes)
        np.testing.assert_array_equal(got.incongruence(np.full(4, 4), parents, tau, lams),
                                      want.incongruence(np.full(4, 4), parents, tau, lams))
        for i in range(4):
            np.testing.assert_array_equal(got.individual(i).genotypes,
                                          want.individual(i).genotypes)
    rolled = pedigree._sort_roll_trace(trace.copy(), np.array([4, 4, 4, 3]), 4)
    np.testing.assert_array_equal(
        rolled, jax_pedigree._sort_roll_trace(trace.copy(), np.array([4, 4, 4, 3]), 4)
    )
    assert list(itertools.chain(rolled[0, 0, 3])).count(-1) == 1
