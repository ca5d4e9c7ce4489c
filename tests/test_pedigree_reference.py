"""The benchmark's plain reference of the pedigree model
(``gpubench/reference/pedigree.py``) against brute-force enumeration and
against the port's own exact oracle, and ``call-pedigree`` on the CPU
judged by it.

The reference factorises a family of two founders and their F1 (the
progeny are independent given the parents); the brute force here sums
every joint genotype of a 2 + 2 family instead, and
``mchap_tpu_torch.testing.exact_pedigree_marginals`` is an exact
enumeration built on the port's ``trio_log_pmf``, written independently.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from gpubench import data, jobs, run
from gpubench.reference import pedigree

torch.set_num_threads(1)
F1 = [[-1, -1], [-1, -1], [0, 1], [0, 1]]


@pytest.mark.parametrize("n_haplotypes, error, frequencies", [
    (3, (0.01, 0.01), None), (4, (0.0, 0.2), [0.1, 0.2, 0.3, 0.4]), (2, (1.0, 0.05), None)])
def test_trio_pmf_rows_sum_to_one(n_haplotypes, error, frequencies):
    fam = pedigree.Family(n_haplotypes, 4, error, frequencies)
    table = fam.trio_table()
    G = fam.n_genotypes
    assert table.shape == (G, G, G) and bool((table >= 0).all())
    assert float((table.sum(dim=2) - 1).abs().max()) < 1e-12
    assert float(fam.founder_prior.sum()) == pytest.approx(1.0, abs=1e-12)


def test_trio_pmf_of_one_parent_pair_by_hand():
    """AAAB x AAAA, error 0: the child takes AA from q, and AA (1/2) or
    AB (1/2) from p; the no-error support is those two genotypes."""
    fam = pedigree.Family(2, 4, (0.0, 0.0))
    rows = {tuple(g): i for i, g in enumerate(fam.gens.tolist())}
    table = fam.trio_table()
    p, q = rows[(0, 0, 0, 1)], rows[(0, 0, 0, 0)]
    want = torch.zeros(fam.n_genotypes, dtype=torch.float64)
    want[rows[(0, 0, 0, 0)]] = want[rows[(0, 0, 0, 1)]] = 0.5
    assert torch.equal(table[p, q], want)


def _brute_force(fam, llks, parents):
    """Marginals [S, G] and PEDERR [S] over every joint genotype."""
    G, S = fam.n_genotypes, len(parents)
    table = fam.trio_table()
    support = fam.support()
    states = torch.tensor(list(itertools.product(range(G), repeat=S)))  # [G^S, S]
    log_w = llks[torch.arange(S), states].sum(dim=1)
    incongruent = torch.zeros(len(states), S, dtype=torch.bool)
    for i, (p, q) in enumerate(parents):
        if p < 0:
            log_w = log_w + torch.log(fam.founder_prior[states[:, i]])
        else:
            a, b, g = states[:, p], states[:, q], states[:, i]
            log_w = log_w + torch.log(table[a, b, g])
            incongruent[:, i] = ~support[a, b, g]
    w = torch.exp(log_w - torch.logsumexp(log_w, 0))
    marginals = torch.zeros(S, G, dtype=torch.float64)
    for i in range(S):
        marginals[i].index_add_(0, states[:, i], w)
    return marginals, (w[:, None] * incongruent).sum(dim=0)


@pytest.mark.parametrize("error", [(0.01, 0.01), (0.2, 0.05)])
def test_factorised_reference_equals_brute_force(error):
    fam = pedigree.Family(3, 4, error)
    llks = torch.as_tensor(np.random.default_rng(1).normal(0, 3, (4, fam.n_genotypes)))
    marginals, pederr = pedigree.f1_posteriors(fam, llks, F1)
    want_m, want_e = _brute_force(fam, llks, F1)
    assert float((marginals - want_m).abs().max()) < 1e-12
    assert float((pederr - want_e).abs().max()) < 1e-12
    assert pederr[:2].tolist() == [0.0, 0.0] and float(pederr[2:].min()) > 0


def test_reference_equals_the_ports_exact_oracle():
    from mchap_tpu_torch.numerics.combinadics import enumerate_genotypes
    from mchap_tpu_torch.testing import exact_pedigree_marginals

    fam = pedigree.Family(3, 4, (0.01, 0.01))
    ours = {tuple(g): i for i, g in enumerate(fam.gens.tolist())}
    vcf_order = [ours[tuple(r)] for r in np.asarray(enumerate_genotypes(3, 4)).tolist()]
    llks = np.random.default_rng(2).normal(0, 3, (4, fam.n_genotypes))
    marginals, _ = pedigree.f1_posteriors(fam, torch.as_tensor(llks), F1)
    want = exact_pedigree_marginals(
        llks[:, vcf_order], np.array(F1), np.full((4, 2), 2), np.zeros((4, 2)),
        np.full((4, 2), 0.01), 3, 4)
    assert np.abs(marginals.numpy()[:, vcf_order] - want).max() < 1e-12


def test_blocks_of_parent_rows_change_nothing(monkeypatch):
    fam = pedigree.Family(4, 4, (0.01, 0.01))
    llks = torch.as_tensor(np.random.default_rng(3).normal(0, 3, (5, fam.n_genotypes)))
    parents = F1 + [[0, 1]]
    whole = pedigree.f1_posteriors(fam, llks, parents)
    monkeypatch.setattr(pedigree, "BLOCK_ENTRIES", 1)  # one parent row a block
    for a, b in zip(whole, pedigree.f1_posteriors(fam, llks, parents)):
        assert float((a - b).abs().max()) < 1e-12


def test_the_reference_refuses_other_pedigrees():
    fam = pedigree.Family(2, 4)
    llks = torch.zeros(4, fam.n_genotypes, dtype=torch.float64)
    with pytest.raises(ValueError, match="two founders and their F1"):
        pedigree.f1_posteriors(fam, llks, [[-1, -1], [-1, -1], [0, 1], [2, 1]])


def test_call_pedigree_on_the_cpu_within_the_cells_limits(tmp_path):
    """``mchap call-pedigree`` through the benchmark's job runner, block
    path, K3's plain version: a 2 + 4 family over 2 loci, judged by the
    tool's judge against the reference, every number within the cell's
    limits (more chains than the cell's to keep the Monte Carlo error
    of a short run small)."""
    cell = run.load_cell("call-pedigree.biparental")
    cell["dataset"] = dict(cell["dataset"], n_samples=6, n_loci=2, snvs_per_locus=[8, 9],
                           reads_per_sample=16, n_triallelic=1, locus_length=120)
    cell["options"] = ["--mcmc-chains", "8", "--mcmc-steps", "300", "--mcmc-burn", "100"]
    cell = run.apply_options(cell)
    d = data.write_pool_one(tmp_path, cell["dataset"], 2**40 + 3, 0)
    cell["samples"] = d["samples"]
    tool = run.load_tool(cell["tool"])
    with tool.tap(2**40 + 5, cell["burn"]) as record:
        job = jobs.run_job(run.job_argv(cell, d, 11, "cpu"), False)
    assert job["ok"], job["error"]
    assert job["paths"] == {"pedigree=plain": 1}
    ref = tool.Reference(d, cell)
    answers, bad_summary = tool.answers_from_vcf(ref, job["vcf"])
    numbers, worst = tool.judge(ref, answers, record, bad_summary)
    print(json.dumps(numbers), json.dumps(worst))
    assert len(record) == 2 and len(answers) == 12
    for name, limit in cell["limits"].items():
        assert numbers[name] <= limit, (name, numbers, worst)
