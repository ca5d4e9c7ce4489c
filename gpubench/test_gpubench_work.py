"""The work counts of the roofline and mfu readers at a small shape, and
the reference's genotype model against a brute-force enumeration."""

import itertools
import math

import numpy as np
import pytest
import torch

from gpubench import run
from gpubench.reference import model

CARD = "NVIDIA H100 80GB HBM3"


def test_k1_count():
    k1 = run.load_metric("k1_roofline")
    cell = dict(ploidy=4, chains=2, temperatures=[0.5, 1.0], steps=10)
    w = k1.problem_work(dict(reads=3, free_alleles=[2, 3]), cell)
    # 3 options (1 + 2) x 4 haplotypes x 3 reads x 5 flops, per chain, rung and step
    assert w == dict(flops=180.0 * 40, transcendentals=4 * (3 * 3 + 5) * 40.0,
                     bytes=4 * 3 * (5 + 1) + 2 * 10 * (4 * 2 + 4.0))


def test_k2_count():
    k2 = run.load_metric("k2_roofline")
    w = k2.problem_work(dict(reads=3, haplotypes=5), dict(ploidy=4, chains=2, steps=10))
    assert w == dict(flops=4 * (3 + 5 * (9 + 1)) * 20.0, transcendentals=4 * 5 * 4 * 20.0,
                     bytes=4 * 3 * 6 + 2 * 10 * 4.0)


def test_roofline_and_mfu_from_a_context():
    k1, mfu = run.load_metric("k1_roofline"), run.load_metric("mfu.sampler")
    cell = dict(tool="assemble", ploidy=4, chains=2, temperatures=[1.0], steps=1000)
    jobs = [dict(ok=True, problems=[dict(reads=10, free_alleles=[2] * 12)] * 440)]
    ctx = dict(cell=cell, jobs=jobs, window_s=30.0, card=CARD, kernel_seconds=lambda p: 0.5)
    work = k1.window_work(ctx)
    least = max(work["flops"] / 67e12, work["transcendentals"] / 4.18176e12,
                work["bytes"] / 3.35e12)
    assert k1.read(ctx) == pytest.approx(100 * least / 0.5)
    assert mfu.read(ctx) == pytest.approx(100 * least / 30.0)
    assert k1.read(dict(ctx, card="a card not in the table")) is None
    assert k1.read(dict(ctx, kernel_seconds=lambda p: 0.0)) is None


def test_kernel_names():
    import re

    k1, k2 = run.load_metric("k1_roofline"), run.load_metric("k2_roofline")
    assert re.search(k1.KERNELS, "void denovo_kernel<4>(Params)")
    assert re.search(k1.KERNELS, "void denovo_ladder_kernel<8>(Params)")
    assert not re.search(k1.KERNELS, "step_kernel(Params)")
    assert re.search(k2.KERNELS, "calling_kernel(Params)")
    assert not re.search(k2.KERNELS, "denovo_kernel<4>(Params)")


def _brute_posterior(dists, counts, haps, ploidy, freqs=None, inbreeding=0.0):
    """Sum over ordered genotypes, grouped by multiset."""
    H = len(haps)
    out = {}
    for ordered in itertools.product(range(H), repeat=ploidy):
        lik = 0.0
        for r in range(len(dists)):
            p = 0.0
            for h in ordered:
                p += np.prod([dists[r, j, haps[h, j]] for j in range(dists.shape[1])
                              if not np.isnan(dists[r, j, 0])]) / ploidy
            lik += counts[r] * math.log(p)
        key = tuple(sorted(ordered))
        if inbreeding:
            # Dirichlet-multinomial over ordered draws, one ordering's share
            a = np.asarray(freqs) * (1 - inbreeding) / inbreeding
            d = np.bincount(key, minlength=H)
            prior = (math.lgamma(a.sum()) - math.lgamma(ploidy + a.sum())
                     + sum(math.lgamma(d[i] + a[i]) - math.lgamma(a[i]) for i in range(H)))
        else:
            prior = 0.0
        out[key] = out.get(key, 0.0) + math.exp(lik + prior)
    total = sum(out.values())
    return {k: v / total for k, v in out.items()}


@pytest.mark.parametrize("inbreeding", [0.0, 0.1])
def test_posterior_matches_brute_force(inbreeding):
    rng = np.random.default_rng(5)
    R, J, P = 6, 3, 3
    calls = rng.integers(-1, 2, size=(R, J))
    dists = np.where(calls[..., None] == np.arange(2), 0.9, 0.1 / 3)
    dists = np.where(calls[..., None] < 0, np.nan, dists)
    haps = np.array([[0, 0, 0], [1, 0, 1], [0, 1, 1]])
    counts = rng.integers(1, 3, size=R).astype(float)
    freqs = np.array([0.5, 0.3, 0.2]) if inbreeding else None
    gens, lp, probs = model.posterior(dists, counts, haps, P, freqs, inbreeding)
    want = _brute_posterior(dists, counts, haps, P, freqs, inbreeding)
    got = {tuple(g.tolist()): float(p) for g, p in zip(gens, probs)}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12)
    # the bfloat16 control computes the same thing, less exactly
    _, _, probs16 = model.posterior(dists, counts, haps, P, freqs, inbreeding, torch.bfloat16)
    assert probs16.dtype == torch.bfloat16
    assert float((probs16.double() - probs).abs().max()) > 1e-4


def test_homozygosity_screen():
    R = 64
    dists = np.full((R, 2, 2), 0.0008)
    dists[:, 0, 0] = 0.9976  # every read calls allele 0 at the first SNV
    dists[: R // 2, 1, 0] = 0.9976  # half the reads each allele at the second
    dists[R // 2:, 1, 1] = 0.9976
    free = model.het_positions(dists, np.ones(R), [2, 2], 4)
    assert free.tolist() == [False, True]


def test_options_set_the_sampler_settings():
    cell = run.load_cell("assemble.parents-tempered")
    assert cell["temperatures"] == [0.2, 0.4, 0.6, 0.8, 1.0]
    assert (cell["chains"], cell["steps"], cell["burn"]) == (2, 2000, 1000)
    cell = run.apply_options(dict(cell, options=["--mcmc-steps", "30", "--mcmc-burn", "10",
                                                 "--use-dirmul-prior", "0.25", "AFP"]))
    assert (cell["steps"], cell["burn"], cell["inbreeding"]) == (30, 10, 0.25)


def test_tabulation_and_the_summary_it_gives():
    from gpubench.reference import judge

    a, b, c = [0, 0], [1, 0], [1, 1]
    # chain states, as the program may hold them: haplotypes in any order
    states = [[a, a, b, b], [b, a, b, a], [a, b, a, b], [a, a, a, c], [a, a, a, b]]
    gens, counts = judge.tabulate(states, [3, 1, 2, 1, 1])
    assert gens.shape == (3, 4, 2)
    assert sorted(zip(counts.tolist(), gens.tolist())) == [
        (1, [a, a, a, b]), (1, [a, a, a, c]), (6, [a, a, b, b])]
    sm = judge.summary_of((gens, counts))
    assert sm["total"] == 8 and len(sm["modes"]) == 1
    mode, n, group = sm["modes"][0]
    # {a, b} groups aabb and aaab: 7 of 8; its heaviest genotype aabb 6 of 8
    assert mode.tolist() == [a, a, b, b] and (n, group) == (6, 7)
    status = judge.reported([sm], 0.2)
    assert status[np.array(b, np.int8).tobytes()] == "yes"
    assert status[np.array(c, np.int8).tobytes()] == "no"  # 1 of 8
    call = dict(resolved=[np.array(h) for h in (a, a, b, b)], n_dot=0, gpm=0.75, spm=0.875)
    assert judge.match_summary(call, sm, status) is not None
    for wrong in (dict(gpm=0.125), dict(spm=0.75), dict(resolved=[np.array(a)] * 2, n_dot=2),
                  dict(resolved=[np.array(h) for h in (a, a, a, b)])):
        assert judge.match_summary(dict(call, **wrong), sm, status) is None
    # a haplotype that no sample reports is written '.'
    sm = judge.summary_of(judge.tabulate([[a, a, a, c]], [1]))
    status = judge.reported([sm], 1.5)
    dotted = dict(resolved=[], n_dot=4, gpm=1.0, spm=1.0)
    assert judge.match_summary(dotted, sm, status) is not None
    assert judge.match_summary(dict(dotted, n_dot=3), sm, status) is None
