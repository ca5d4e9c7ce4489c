"""K3's plain version against the JAX pedigree kernel, on the CPU.

The JAX kernel runs in interpret mode, whose PRNG yields the same value
(1e-12) for every draw: its Gumbel-max draws become a greedy arg-max and
its pair swaps accept whenever exp(log ratio) > 1e-12.  The port's plain
K3 with every uniform pinned to 1e-12 is then the same deterministic
sweep, and the traces must be equal.  On a selfed pedigree and a
backcross the JAX kernel scores the blanket wrongly (ROADMAP queue 3);
there both are held against an f64 greedy mirror built on the port's
log-domain ``trio_log_pmf``, which the port matches and the JAX kernel
does not.  The last test checks that K3's read terms do not floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mchap_tpu.ops.likelihood import prepare_reads, read_hap_loglik
from mchap_tpu.ops.pallas_pedigree import make_plan, pallas_pedigree_sampler
from mchap_tpu.testing import simulate_reads
from mchap_tpu_torch.ops import cuda_pedigree as K3
from mchap_tpu_torch.ops import pedigree_mcmc as TK

torch.set_num_threads(1)

PINNED = 1e-12  # the JAX interpreter's value of every uniform draw


def _read_hap(reads_list, haps):
    R = max(len(r) for r in reads_list)
    rh = np.full((len(reads_list), R, len(haps)), -1e30)
    counts = np.zeros((len(reads_list), R))
    for i, r in enumerate(reads_list):
        rh[i, : len(r)] = np.asarray(
            read_hap_loglik(prepare_reads(np.asarray(r, float)), jnp.asarray(haps))
        )
        counts[i, : len(r)] = 1
    return rh, counts


def _jax(init, rh, counts, freqs, ploidy, parents, tau, err, steps, swap, n_valid=None):
    lanes = 128

    def wide(a):
        return np.repeat(np.asarray(a)[..., None], lanes, axis=-1)

    plan = make_plan(ploidy, parents, tau, np.zeros(tau.shape), err, swap)
    trace = pallas_pedigree_sampler(
        jnp.int32(3), jnp.asarray(wide(rh), jnp.float32),
        jnp.asarray(wide(counts), jnp.float32), jnp.asarray(wide(freqs), jnp.float32),
        jnp.asarray(np.full(lanes, n_valid or rh.shape[-1], np.int32)),
        jnp.asarray(wide(init), np.int32), plan=plan, n_steps=steps, interpret=True,
    )
    return np.asarray(trace)[..., 0]  # [steps, S, maxp]


def _port(init, rh, counts, freqs, ploidy, parents, tau, err, steps, swap, n_valid=None):
    plan = K3.Plan(ploidy, parents, tau, np.zeros(tau.shape), err, swap)
    H = rh.shape[-1]
    trace = K3.pedigree_sampler(
        torch.tensor(rh, dtype=torch.float32)[None],
        torch.tensor(counts, dtype=torch.float32)[None],
        torch.tensor(freqs, dtype=torch.float64)[None],
        torch.tensor([n_valid or H], dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        torch.tensor(init, dtype=torch.int32)[None], plan, n_steps=steps,
        noise=torch.full((steps, plan.n_draws(H), 1), PINNED),
    )
    return trace[0].numpy().astype(np.int64)


def _mirror(init, rh, counts, freqs, ploidy, parents, tau, err, steps, swap):
    """f64 greedy sweep (and greedy pair swaps) on the port's log-domain
    trio pmf: every blanket member scored once, with live doses."""
    g = np.array(init)
    S, maxp = g.shape
    H = rh.shape[-1]
    tables, valid = (torch.as_tensor(x) for x in TK.composition_tables(maxp))
    lut, lf = torch.as_tensor(TK._COMB_LUT), torch.as_tensor(np.log(freqs))
    children = [[i for i in range(S) if r in parents[i]] for r in range(S)]

    def trio(i, gg):
        p, q = parents[i]
        none = np.full(maxp, -1)
        return float(TK.trio_log_pmf(
            torch.as_tensor(gg[i]), torch.as_tensor(gg[p] if p >= 0 else none),
            torch.as_tensor(gg[q] if q >= 0 else none),
            int(ploidy[p]) if p >= 0 else 0, int(ploidy[q]) if q >= 0 else 0,
            int(tau[i, 0]), int(tau[i, 1]), 0.0, 0.0,
            float(err[i, 0]) if p >= 0 else 1.0, float(err[i, 1]) if q >= 0 else 1.0,
            lf, tables.long(), valid, lut,
        ))

    def llk(i, gg):
        sub = rh[i][:, gg[i, : int(ploidy[i])]]
        return float(counts[i] @ (np.logaddexp.reduce(sub, axis=1) - np.log(ploidy[i])))

    pairs = []
    for i in range(S):
        p, q = sorted(parents[i])
        if p >= 0 and p != q and (p, q) not in pairs:
            pairs.append((p, q))
    for _ in range(steps):
        for s in K3.update_order(ploidy, parents, tau, err):
            for k in range(int(ploidy[s])):
                scores = []
                for h in range(H):
                    g2 = g.copy()
                    g2[s, k] = h
                    copies = sum(g2[s, j] == h for j in range(int(ploidy[s])) if j != k)
                    scores.append(llk(s, g2) + trio(s, g2)
                                  + sum(trio(c, g2) for c in children[s]) + np.log1p(copies))
                g[s, k] = int(np.argmax(scores))
        for p, q in pairs if swap else ():
            ap, aq = g[p, 0], g[q, 0]  # pinned draws pick slot 0
            if ap == aq:
                continue

            def n(row, a, P):
                return int((row[:P] == a).sum())

            lprop = np.log((1 + n(g[p], aq, ploidy[p])) * (1 + n(g[q], ap, ploidy[q]))) - np.log(
                max(n(g[p], ap, ploidy[p]) * n(g[q], aq, ploidy[q]), 1))
            g2 = g.copy()
            g2[p, 0], g2[q, 0] = aq, ap
            blanket = sorted({p, q, *children[p], *children[q]})
            log_acc = min(0.0, llk(p, g2) + llk(q, g2) - llk(p, g) - llk(q, g)
                          + sum(trio(x, g2) - trio(x, g) for x in blanket) + lprop)
            if PINNED < np.exp(log_acc):
                g = g2
    return g


HAPS2 = np.array([[0, 0], [0, 1], [1, 1]], dtype=np.int8)
TRIO = np.array([[-1, -1], [-1, -1], [0, 1]])


def _diploid_trio(seed=1):
    truths = [HAPS2[[0, 1]], HAPS2[[1, 2]], HAPS2[[0, 2]]]
    reads = [simulate_reads(t, n_alleles=2, n_reads=6, qual=(14, 16), seed=i)
             for i, t in enumerate(truths)]
    rh, counts = _read_hap(reads, HAPS2)
    init = np.random.default_rng(seed).integers(0, 3, (3, 2))
    return rh, counts, init


def _family(n_progeny=4, seed=1):
    rng = np.random.default_rng(seed)
    haps = np.zeros((8, 6), np.int8)
    haps[1:] = rng.integers(0, 2, (7, 6))
    n = 2 + n_progeny
    parents = np.full((n, 2), -1)
    parents[2:] = [0, 1]
    f0, f1 = rng.choice(8, 4), rng.choice(8, 4)
    truth = [f0, f1] + [
        np.concatenate([rng.choice(f0, 2, replace=False), rng.choice(f1, 2, replace=False)])
        for _ in range(n_progeny)
    ]
    reads = [simulate_reads(haps[t], n_alleles=2, n_reads=8, qual=(14, 20), seed=100 + i)
             for i, t in enumerate(truth)]
    rh, counts = _read_hap(reads, haps)
    return rh, counts, rng.integers(0, 8, (n, 4)), parents


@pytest.mark.parametrize(
    "case", ["diploid trio", "tetraploid family", "padded panel", "mixed ploidy"]
)
def test_plain_k3_equals_jax_kernel_greedy(case):
    swap = True
    if case == "mixed ploidy":  # tetraploid x diploid -> triploid, tau (2, 1)
        ploidy = np.array([4, 2, 3])
        truths = [HAPS2[[0, 0, 1, 1]], HAPS2[[1, 2]], HAPS2[[0, 1, 2]]]
        reads = [simulate_reads(t, n_alleles=2, n_reads=8, qual=(14, 18), seed=i)
                 for i, t in enumerate(truths)]
        rh, counts = _read_hap(reads, HAPS2)
        rng = np.random.default_rng(0)
        init = np.full((3, 4), -1)
        for i, P in enumerate(ploidy):
            init[i, :P] = rng.integers(0, 3, P)
        args = (np.array([0.5, 0.3, 0.2]), ploidy, TRIO, np.array([[2, 2], [1, 1], [2, 1]]),
                np.full((3, 2), 0.05))
        steps, n_valid = 3, None
    elif case == "tetraploid family":
        rh, counts, init, parents = _family()
        n = len(parents)
        args = (np.full(8, 1 / 8), np.full(n, 4), parents, np.full((n, 2), 2),
                np.full((n, 2), 0.1))
        steps, n_valid = 2, None
    else:
        rh, counts, init = _diploid_trio()
        freqs = np.array([0.5, 0.3, 0.2])
        n_valid = None
        if case == "padded panel":
            rh = np.concatenate([rh, np.full(rh.shape[:2] + (3,), -1e30)], -1)
            freqs, n_valid = np.concatenate([freqs, np.zeros(3)]), 3
        args = (freqs, np.full(3, 2), TRIO, np.ones((3, 2), int), np.full((3, 2), 0.05))
        steps = 3
    want = _jax(init, rh, counts, *args, steps, swap, n_valid=n_valid)
    got = _port(init, rh, counts, *args, steps, swap, n_valid=n_valid)
    np.testing.assert_array_equal(got, want)
    assert (want[-1] != init).any()  # the sweep moved: the comparison is not vacuous
    assert want.max() < rh.shape[-1] if n_valid is None else want.max() < n_valid


@pytest.mark.parametrize("pedigree", ["selfed", "backcross"])
def test_faults_not_copied(pedigree):
    """Selfing (the JAX kernel reads the co-parent's stale dose) and a
    backcross (its pair blanket counts the child pair member twice): the
    port equals the f64 mirror, the JAX kernel does not."""
    H = 4
    if pedigree == "selfed":
        seed, err, scale, swap = 0, 0.05, 2.0, False
        parents = np.array([[-1, -1], [0, 0], [-1, -1], [0, 2]])
    else:
        seed, err, scale, swap = 8, 1e-6, 0.3, True
        parents = np.array([[-1, -1], [-1, -1], [0, 1], [0, 2]])
    rng = np.random.default_rng(seed)
    ploidy, tau, errs = np.full(4, 2), np.ones((4, 2), int), np.full((4, 2), err)
    rh = -rng.gamma(1.0, scale, size=(4, 6, H))
    counts, freqs = np.ones((4, 6)), rng.dirichlet(np.ones(H))
    init = rng.integers(0, H, (4, 2))
    args = (init, rh, counts, freqs, ploidy, parents, tau, errs, 2, swap)
    want = _mirror(*args)
    np.testing.assert_array_equal(_port(*args)[-1], want)
    assert (_jax(*args)[-1] != want).any()


def test_update_order_matches_jax_plan():
    parents = np.array([[-1, -1], [-1, -1], [0, 1], [-1, -1], [2, 3], [0, 1], [2, 3]])
    n = len(parents)
    ploidy, tau, err = np.full(n, 2), np.ones((n, 2), int), np.full((n, 2), 0.01)
    err[5] = 0.2  # a sibling with another configuration: its own group
    plan = make_plan(ploidy, parents, tau, np.zeros((n, 2)), err, True)
    want = [int(m) for _, members, _, _ in plan.groups for m in members]
    assert K3.update_order(ploidy, parents, tau, err) == want
    assert want != sorted(want)  # groups are not in sample order here


def test_read_terms_do_not_floor():
    """One read lies more than 70 nats below every haplotype but one; the
    JAX kernel floors such exp sums at 1e-30.  K3's candidate llks match
    an f64 recompute within 1e-4 relative."""
    rng = np.random.default_rng(0)
    H, R, P = 5, 6, 4
    rh = -rng.gamma(2.0, 1.0, size=(R, H))
    rh[0] = [-0.5, -80.0, -85.0, -90.0, -95.0]
    rows = np.array([1, 2, 3, 3])  # every current slot far below read 0's best
    counts = rng.integers(1, 3, R).astype(float)
    for k in range(P):
        got = K3.candidate_llks(
            torch.tensor(rh, dtype=torch.float32)[None],
            torch.tensor(counts, dtype=torch.float32)[None],
            torch.tensor(rows)[None], k, P,
        )[0].numpy()
        want = []
        for h in range(H):
            g = rows.copy()
            g[k] = h
            want.append(counts @ (np.logaddexp.reduce(rh[:, g], axis=1) - np.log(P)))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    # the floored form the TPU kernel computes is off by nats on read 0
    floored = np.log(np.maximum(np.exp(rh[0, [2, 3, 3]] - rh[0].max()).sum(), 1e-30))
    exact = np.logaddexp.reduce(rh[0, [2, 3, 3]] - rh[0].max())
    assert exact - floored < -5
