"""The torch de novo sampler (``mchap_tpu_torch/ops/assemble_mcmc.py``)
against ``mchap_tpu``'s XLA sampler (``mchap_tpu/ops/assemble_mcmc.py``).

- Deterministic pieces equal JAX's on the CPU: segment labels, the
  recombination and dosage option tables and their counts, the prior
  from row equality, the initial ``rh`` and llk, and each sub-step (a
  mutation sweep, an interval step, the interval draw, a tempering swap)
  fed the draws JAX's own sub-step makes from its key.
- The sampler's posterior, through ``DenovoMCMC`` and ``fit_denovo_multi``
  on the CPU, against exact enumeration over the full haplotype space at
  the tolerance of ``tests/test_assemble_mcmc.py`` (0.05 per genotype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mchap_tpu.ops import assemble_mcmc as J
from mchap_tpu.ops.likelihood import log_likelihood, read_hap_loglik
from mchap_tpu.ops.likelihood import prepare_reads as jax_prepare_reads
from mchap_tpu_torch.ops import assemble_mcmc as T

# Many small torch ops: beside the test runner's parallel workers,
# torch's own thread pool only contends for the cores.
torch.set_num_threads(1)

# label matrices of tests/test_structural_options.py
STRUCTURAL_LABELS = [
    [[0, 0], [1, 0]],
    [[0, 0], [1, 1]],
    [[0, 0], [0, 0]],
    [[0, 0], [0, 1], [0, 1], [0, 0]],
    [[0, 0], [0, 1], [2, 1], [0, 0]],
    [[0, 0], [0, 1], [2, 1], [3, 0]],
    [[0, 0], [1, 1], [2, 2], [3, 3]],
    [[0, 0], [0, 0], [0, 0], [3, 0]],
    [[0, 0], [0, 1], [2, 0], [2, 0]],
    [[0, 0], [0, 1], [2, 2], [2, 3], [4, 4], [4, 5]],
]


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _genotypes(rng, n, ploidy, nb, n_alleles=2):
    """Genotypes with many equal rows and segments: rows drawn from a
    small pool."""
    pool = rng.integers(0, n_alleles, size=(n, 3, nb))
    rows = rng.integers(0, 3, size=(n, ploidy))
    return np.take_along_axis(pool, rows[:, :, None], axis=1)


def _masks(rng, n, nb):
    start = rng.integers(0, nb, n)
    end = np.minimum(start + rng.integers(0, nb + 1, n), nb)
    pos = np.arange(nb)
    return (pos[None] >= start[:, None]) & (pos[None] < end[:, None])


def _assert_options_equal(labels_t, labels_j):
    for fn, count in (("recombination_options", "recombination_n_options"),
                      ("dosage_options", "dosage_n_options")):
        opts_t, valid_t = getattr(T, fn)(labels_t)
        opts_j, valid_j = jax.vmap(getattr(J, fn))(labels_j)
        np.testing.assert_array_equal(opts_t.numpy(), np.asarray(opts_j))
        np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
        np.testing.assert_array_equal(
            getattr(T, count)(opts_t).numpy(), np.asarray(getattr(J, count)(opts_j))
        )


@pytest.mark.parametrize("ploidy", [2, 4, 6, 16])
def test_labels_and_option_tables_match_jax(ploidy):
    """Labels of seeded genotypes and random intervals, then the option
    tables of those labels and of tests/test_structural_options.py's."""
    rng = np.random.default_rng(ploidy)
    nb = 5
    g = _genotypes(rng, 24, ploidy, nb)
    mask = _masks(rng, 24, nb)
    labels_t = T.segment_labels(_t(g), _t(mask))
    labels_j = jax.vmap(J.segment_labels)(jnp.asarray(g), jnp.asarray(mask))
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    cases = np.asarray([x for x in STRUCTURAL_LABELS if len(x) == ploidy]).reshape(
        -1, ploidy, 2)
    labels = np.concatenate([labels_t.numpy(), cases])
    _assert_options_equal(_t(labels), jnp.asarray(labels))


@pytest.mark.parametrize("inbreeding", [0.0, 0.2])
def test_prior_from_row_equality_matches_jax(inbreeding):
    rng = np.random.default_rng(3)
    for ploidy in (2, 4, 7):
        g = _genotypes(rng, 16, ploidy, 4, n_alleles=3)
        log_uh = np.log(rng.integers(2, 40, 16).astype(float))
        eq_t = T._row_eq(_t(g))
        eq_j = jax.vmap(J._row_eq)(jnp.asarray(g))
        np.testing.assert_array_equal(eq_t.numpy(), np.asarray(eq_j))
        got = T._genotype_prior_from_eq(eq_t, _t(log_uh), torch.full((16,), inbreeding))
        want = jax.vmap(J._genotype_prior_from_eq, (0, 0, None))(eq_j, log_uh, inbreeding)
        # lgamma differs between the two libraries in its last bits
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-7)


def _problem(rng, ploidy, nb, A, R, n_chains):
    """Reads with gaps and impossible alleles, a seeded state, JAX's and
    the port's log reads."""
    reads = rng.dirichlet(np.ones(A), size=(R, nb))
    reads[rng.random((R, nb)) < 0.2] = np.nan
    reads[:, 0, A - 1] = 0.0  # an allele no read allows
    counts = rng.integers(1, 4, R).astype(float)
    n_alleles = np.full(nb, A)
    n_alleles[1] = 1  # a fixed position
    g = rng.integers(0, A, size=(n_chains, ploidy, nb))
    g[:, :, 1] = 0
    g[:, :, 0] = np.minimum(g[:, :, 0], A - 2)
    lr = np.asarray(jax_prepare_reads(reads))
    return reads, counts, n_alleles, g, lr


def _torch_state(lr, counts, g):
    lr_t = _t(lr)[None].permute(0, 2, 1, 3).contiguous()
    problem = torch.zeros(len(g), dtype=torch.long)
    counts_b = _t(counts)[None].expand(len(g), -1)
    rh, llk = T.initial_state(lr_t, problem, counts_b, _t(g, torch.long))
    return lr_t, problem, counts_b, rh, llk


@pytest.mark.parametrize("ploidy", [1, 4, 13])
def test_initial_state_matches_jax(ploidy):
    rng = np.random.default_rng(ploidy)
    reads, counts, _, g, lr = _problem(rng, ploidy, 6, 3, 12, 5)
    _, _, _, rh, llk = _torch_state(lr, counts, g)
    for b in range(len(g)):
        np.testing.assert_allclose(
            rh[b].numpy(), np.asarray(read_hap_loglik(jnp.asarray(lr), jnp.asarray(g[b]))),
            rtol=1e-12,
        )
        want = float(log_likelihood(reads, jnp.asarray(g[b]), counts))
        np.testing.assert_allclose(float(llk[b]), want, rtol=1e-12)


def _jax_rh_llk(lr, counts, g):
    rh = read_hap_loglik(jnp.asarray(lr), g)
    llk = counts @ (jax.scipy.special.logsumexp(rh, axis=-1) - jnp.log(g.shape[0]))
    return rh, llk


@pytest.mark.parametrize("ploidy,use_prior", [(3, False), (4, True)])
def test_mutation_sweep_matches_jax(ploidy, use_prior):
    """A sweep per chain, each fed the site order and uniforms JAX's
    ``mutation_sweep`` draws from its key."""
    rng = np.random.default_rng(10 + ploidy)
    nb, A, n = 5, 3, 6
    reads, counts, n_alleles, g, lr = _problem(rng, ploidy, nb, A, 16, n)
    log_uh = float(np.log(n_alleles).sum())
    inbreeding = np.where(np.arange(n) % 2, 0.25, 0.0)
    temp = np.linspace(0.5, 1.0, n)
    lr_t, problem, counts_b, rh, llk = _torch_state(lr, counts, g)
    keys = jax.random.split(jax.random.PRNGKey(ploidy), n)
    orders, us = [], []
    for key in keys:
        kperm, ksites = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(kperm, ploidy * nb)))
        us.append(jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float64))(
            jax.random.split(ksites, ploidy * nb)))
    sweep = jax.jit(jax.vmap(
        lambda k, g, rh, llk, t, f: J.mutation_sweep(
            k, g, rh, llk, jnp.asarray(lr), jnp.asarray(counts), jnp.asarray(n_alleles),
            log_uh, t, use_prior, f),
    ))
    rh_j, llk_j = jax.vmap(lambda g: _jax_rh_llk(lr, counts, g))(jnp.asarray(g))
    want = zip(*sweep(keys, jnp.asarray(g), rh_j, llk_j, temp, inbreeding))
    g_t, rh_t, llk_t = T.mutation_sweep(
        _t(g, torch.long), rh, llk, lr_t, problem, counts_b,
        _t(n_alleles, torch.long)[None].expand(n, -1), torch.full((n,), log_uh),
        _t(temp), _t(inbreeding) if use_prior else None, _t(orders, torch.long), _t(us),
    )
    for b, (g_j, rh_j, llk_j) in enumerate(want):
        np.testing.assert_array_equal(g_t[b].numpy(), np.asarray(g_j))
        np.testing.assert_allclose(rh_t[b].numpy(), np.asarray(rh_j), rtol=1e-10)
        np.testing.assert_allclose(float(llk_t[b]), float(llk_j), rtol=1e-10)
    # the sweeps moved some chains, and the incremental state equals its
    # definition on the final genotypes
    assert (g_t.numpy() != g).any()
    rh_def, llk_def = T.initial_state(lr_t, problem, counts_b, g_t)
    np.testing.assert_allclose(rh_t.numpy(), rh_def.numpy(), rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(llk_t.numpy(), llk_def.numpy(), rtol=1e-10)


@pytest.mark.parametrize("step_type,use_prior", [(0, False), (0, True), (1, True)])
def test_interval_step_matches_jax(step_type, use_prior):
    rng = np.random.default_rng(20 + step_type)
    ploidy, nb, A, n = 4, 6, 2, 24
    reads, counts, _, _, lr = _problem(rng, ploidy, nb, A, 10, n)
    g = _genotypes(rng, n, ploidy, nb, A)
    g[:, :, 0] = 0  # the allele no read allows
    mask = _masks(rng, n, nb)
    log_uh = float(nb * np.log(A))
    inbreeding = np.where(np.arange(n) % 2, 0.3, 0.0)
    temp = np.linspace(0.3, 1.0, n)
    lr_t, problem, counts_b, rh, llk = _torch_state(lr, counts, g)
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    us = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float64))(keys)
    start = np.where(mask.any(1), np.argmax(mask, 1), nb)
    intervals = np.stack([start, start + mask.sum(1)], -1)
    step = jax.jit(jax.vmap(
        lambda k, g, rh, llk, iv, t, f: J.interval_step(
            k, g, rh, llk, iv, jnp.asarray(lr), jnp.asarray(counts), log_uh, t,
            step_type, use_prior, f),
    ))
    rh_j, llk_j = jax.vmap(lambda g: _jax_rh_llk(lr, counts, g))(jnp.asarray(g))
    want = zip(*step(keys, jnp.asarray(g), rh_j, llk_j, jnp.asarray(intervals), temp,
                     inbreeding))
    g_t, rh_t, llk_t = T.interval_step(
        _t(g, torch.long), rh, llk, _t(mask), lr_t, problem, counts_b,
        torch.full((n,), log_uh), _t(temp), _t(inbreeding) if use_prior else None,
        step_type, _t(us),
    )
    for b, (g_j, rh_j, llk_j) in enumerate(want):
        np.testing.assert_array_equal(g_t[b].numpy(), np.asarray(g_j))
        np.testing.assert_allclose(rh_t[b].numpy(), np.asarray(rh_j), rtol=1e-10)
        np.testing.assert_allclose(float(llk_t[b]), float(llk_j), rtol=1e-10)
    assert (g_t.numpy() != g).any()


@pytest.mark.parametrize("nb", [1, 9])
def test_random_intervals_match_jax(nb):
    rng = np.random.default_rng(nb)
    n = 16
    dist = rng.dirichlet(np.ones(nb), size=n)
    u_n, points, order, want = [], [], [], []
    for b, key in enumerate(jax.random.split(jax.random.PRNGKey(nb), n)):
        kn, kp, ks = jax.random.split(key, 3)
        u_n.append(float(jax.random.uniform(kn, dtype=jnp.float64)))
        points.append(np.asarray(jax.random.permutation(kp, nb - 1) + 1) if nb > 1
                      else np.zeros(0, int))
        order.append(np.asarray(jax.random.permutation(ks, nb)))
        want.append(np.asarray(J.random_intervals(key, nb, jnp.asarray(dist[b]))))
    starts, ends = T.intervals_from_draws(
        _t(dist), _t(u_n), _t(np.stack(points), torch.long), _t(order, torch.long)
    )
    np.testing.assert_array_equal(torch.stack([starts, ends], -1).numpy(), np.stack(want))


@pytest.mark.parametrize("use_prior", [False, True])
def test_chain_swaps_match_jax(use_prior):
    rng = np.random.default_rng(7)
    ploidy, nb, A, n, n_temps = 4, 4, 2, 12, 3
    reads, counts, _, _, lr = _problem(rng, ploidy, nb, A, 8, n * n_temps)
    g = _genotypes(rng, n * n_temps, ploidy, nb, A)
    temps = np.array([0.2, 0.6, 1.0])
    log_uh = float(nb * np.log(A))
    inbreeding = np.where(np.arange(n) % 2, 0.4, 0.0)
    _, _, _, rh, llk = _torch_state(lr, counts, g)
    view = lambda x: x.view((n, n_temps) + x.shape[1:])  # noqa: E731
    g_t, rh_t, llk_t = view(_t(g, torch.long)), view(rh.clone()), view(llk.clone())
    us = []
    for c, key in enumerate(jax.random.split(jax.random.PRNGKey(1), n)):
        gs, rhs, llks = list(g_t[c].numpy()), list(rh_t[c].numpy()), list(llk_t[c].numpy())
        u = []
        for t, k in zip(range(1, n_temps), jax.random.split(key, n_temps - 1)):
            u.append(float(jax.random.uniform(k, dtype=jnp.float64)))
            out = J.chain_swap(k, gs[t], rhs[t], llks[t], temps[t], gs[t - 1], rhs[t - 1],
                               llks[t - 1], temps[t - 1], log_uh, use_prior, inbreeding[c])
            gs[t], rhs[t], llks[t], gs[t - 1], rhs[t - 1], llks[t - 1] = out
        us.append(u)
        if c == 0:
            want = []
        want.append((np.stack(gs), np.stack(rhs), np.stack(llks)))
    T.chain_swaps(g_t, rh_t, llk_t, _t(temps), torch.full((n,), log_uh),
                  _t(inbreeding) if use_prior else None, _t(us))
    for c, (g_j, rh_j, llk_j) in enumerate(want):
        np.testing.assert_array_equal(g_t[c].numpy(), g_j)
        np.testing.assert_array_equal(rh_t[c].numpy(), rh_j)
        np.testing.assert_array_equal(llk_t[c].numpy(), llk_j)


# ---------------------------------------------------------------------------
# the sampler's posterior against exact enumeration
# ---------------------------------------------------------------------------

PANEL = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)  # all haplotypes of 2 SNVs


def _sampled_posterior(genotypes, ploidy):
    """Posterior over genotypes of PANEL, in its VCF order, from every
    kept step of every chain of genotypes [..., ploidy, 2]."""
    from mchap_tpu_torch.numerics.combinadics import (
        count_unique_genotypes,
        genotype_alleles_as_index,
    )

    codes = np.sort(genotypes[..., 0] * 2 + genotypes[..., 1], axis=-1)
    idx = genotype_alleles_as_index(codes.reshape(-1, ploidy))
    got = np.bincount(idx, minlength=count_unique_genotypes(len(PANEL), ploidy))
    return got / got.sum()


def _exact_posterior(reads, ploidy, inbreeding=None):
    from mchap_tpu_torch.numerics.combinadics import enumerate_genotypes
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.priors import log_genotype_prior

    llks = exact.genotype_likelihoods(reads, ploidy, PANEL)
    if inbreeding is not None:
        table = torch.as_tensor(enumerate_genotypes(len(PANEL), ploidy))
        llks = llks + log_genotype_prior(table, len(PANEL), inbreeding=inbreeding)
    return exact.genotype_posteriors(llks).numpy()


def _reads(truth, n_reads, qual, seed, **kw):
    from mchap_tpu_torch.testing import simulate_reads

    return simulate_reads(np.asarray(truth, np.int8), n_alleles=2, n_reads=n_reads,
                          qual=qual, seed=seed, **kw)


def _fit(reads, ploidy, steps, chains, **kw):
    from mchap_tpu_torch.models.assemble import DenovoMCMC
    from mchap_tpu_torch.utils import fallback

    fallback.PATHS.clear()
    kw = dict(dict(n_alleles=[2, 2]), **kw)
    trace = DenovoMCMC(ploidy=ploidy, steps=steps, chains=chains, random_seed=7,
                       device="cpu", **kw).fit(reads)
    return trace, dict(fallback.PATHS)


TRUTH_P4 = [[0, 0], [0, 0], [0, 1], [1, 1]]


@pytest.mark.parametrize(
    "ploidy,kw",
    [
        (4, dict(fix_homozygous=0.999, n_intervals=1)),
        (4, dict(fix_homozygous=1.1, n_intervals=1)),
        (4, dict(n_intervals=2)),
        (4, dict(temperatures=tuple(np.linspace(0.2, 1.0, 9)))),
        (14, dict(fix_homozygous=1.1)),
    ],
    ids=["P4-fix", "P4-nofix", "n_intervals=2", "9-rungs", "P14"],
)
def test_posterior_matches_exact(ploidy, kw):
    """The cases of tests/test_assemble_mcmc.py:45 (P4 over 2 SNVs, the
    homozygote screen on and off), two intervals, 9 rungs and ploidy 14:
    each on the torch route, within 0.05 of exact enumeration."""
    if ploidy == 4:
        reads, steps = _reads(TRUTH_P4, 8, (15, 25), 3), 160
        chains = 16 if "temperatures" in kw else 24
    else:
        reads = _reads(TRUTH_P4 * 3 + [[0, 1], [1, 0]], 6, (15, 25), 3)
        steps, chains = 110, 12
    trace, paths = _fit(reads, ploidy, steps, chains, **kw)
    assert paths == {("denovo", "torch"): 1}
    got = _sampled_posterior(trace.burn(40).genotypes, ploidy)
    want = _exact_posterior(reads, ploidy)
    print(f"max |sampled - exact| {np.abs(got - want).max():.4f}")
    np.testing.assert_allclose(got, want, atol=0.05)


def test_route_llks_equal_the_definition():
    """With the homozygote screen fixing positions, the torch route
    samples only the het columns and adds the fixed columns' constant
    back: each recorded llk equals mchap_tpu's log likelihood of the
    recorded genotype over every position."""
    truth = [[0, 0, 1, 1], [0, 1, 1, 0], [1, 1, 1, 0], [0, 0, 1, 1]]
    reads = _reads(truth, 30, (20, 30), 4)
    trace, paths = _fit(reads, 4, 20, 3, n_intervals=2, n_alleles=[2, 2, 2, 2])
    assert paths == {("denovo", "torch"): 1}
    for c in range(3):
        for step in (0, 19):
            want = float(log_likelihood(reads, jnp.asarray(trace.genotypes[c, step])))
            np.testing.assert_allclose(trace.llks[c, step], want, rtol=1e-10)


def test_mixed_inbreeding_batch_matches_exact():
    """One block, one problem at F = 0 and one at F = 0.2: K1 refuses it,
    the torch route samples each under its own prior."""
    from mchap_tpu_torch.models.assemble import fit_denovo_multi
    from mchap_tpu_torch.utils import fallback

    reads = _reads(TRUTH_P4, 8, (15, 25), 3)
    fallback.PATHS.clear()
    traces = fit_denovo_multi(
        [dict(reads=reads, counts=np.ones(len(reads)), n_alleles=[2, 2], inbreeding=f)
         for f in (0.0, 0.2)],
        4, steps=160, chains=16, burn=40, random_seed=5, device="cpu",
    )
    assert dict(fallback.PATHS) == {("denovo", "torch"): 1}
    for f, trace in zip((0.0, 0.2), traces):
        assert trace.pre_burned == 40 and trace.genotypes.shape == (16, 120, 4, 2)
        np.testing.assert_allclose(
            _sampled_posterior(trace.genotypes, 4), _exact_posterior(reads, 4, f),
            atol=0.05,
        )


def test_prior_only_six_reads():
    """Chip phase O's prior-only case at 6 reads of quality 12-16 and
    F = 0.5, where K1's systematic row order reads TV 0.0259 (ROADMAP
    queue 3, fault 3), on the torch sampler with its shuffled site order:
    bound 0.03."""
    from mchap_tpu_torch.ops.likelihood import prepare_reads

    reads = _reads([[0, 0], [0, 1], [1, 1], [0, 0]], 6, (12, 16), 11,
                   errors=False, uniform_sample=True)
    chains = 32
    generator = torch.Generator().manual_seed(11)
    initial = torch.randint(0, 2, (1, chains, 4, 2), generator=generator)
    genotypes, _ = T.denovo_sampler(
        11, 0, initial, prepare_reads(reads)[None], torch.ones((1, len(reads))),
        torch.full((1, 2), 2), torch.tensor([[0.75, 0.25]]), [1.0], n_steps=200,
        burn=40, inbreeding=torch.tensor([0.5]),
    )
    got = _sampled_posterior(genotypes.numpy(), 4)
    tv = 0.5 * np.abs(got - _exact_posterior(reads, 4, 0.5)).sum()
    print(f"phase O's prior-only 6-read case on the torch sampler: TV {tv:.4f} (bound 0.03)")
    assert tv < 0.03


def test_row_chunks_change_nothing(monkeypatch):
    """A block too large for one piece runs its interval steps and initial
    read sums a few chain-rungs at a time (``rows_per_chunk``): the same
    draws then give the same trace, bit for bit."""
    from mchap_tpu_torch.ops.likelihood import prepare_reads

    rng = np.random.default_rng(12)
    S, C, ploidy, nb = 3, 4, 4, 5
    reads = np.stack([_reads(rng.integers(0, 2, (ploidy, nb)), 16, (15, 25), s)
                      for s in range(S)])
    initial = torch.as_tensor(rng.integers(0, 2, (S, C, ploidy, nb)))
    args = (initial, prepare_reads(reads.reshape(-1, nb, 2)).view(S, 16, nb, 2),
            torch.ones((S, 16)), torch.full((S, nb), 2), torch.full((S, nb), 1.0 / nb),
            [0.5, 1.0])
    kw = dict(n_steps=6, burn=2, inbreeding=torch.tensor([0.0, 0.1, 0.2]))

    def run():
        return T.denovo_sampler(3, 0, *args, **kw)

    whole = run()
    rows, step = [], T._interval_step
    monkeypatch.setattr(T, "rows_per_chunk", lambda *a: 5)
    monkeypatch.setattr(T, "_interval_step", lambda g, *a: rows.append(len(g)) or step(g, *a))
    chunked = run()
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert max(rows) == 5 and min(rows) == S * C * 2 % 5
