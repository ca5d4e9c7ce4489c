"""The frozen data writer repeats from a seed, and the reference reads
back what it wrote."""

import filecmp
import json

import numpy as np

from gpubench import data, run
from gpubench.reference import reads

SMALL = dict(n_samples=4, n_loci=3, snvs_per_locus=[9, 8, 10], ploidy=4, reads_per_sample=16,
             n_triallelic=1, error_rate=0.0024, n_founders=6, locus_length=120,
             founder_snvs=6, pedigree=True)


def _files(d):
    return sorted(p.name for p in d.iterdir())


def test_same_seed_same_files_other_seed_other_files(tmp_path):
    a = data.write_pool_one(tmp_path / "a", SMALL, 2**40 + 3, 1)
    b = data.write_pool_one(tmp_path / "b", SMALL, 2**40 + 3, 1)
    c = data.write_pool_one(tmp_path / "c", SMALL, 2**40 + 4, 1)
    names = _files(tmp_path / "a" / "d1")
    assert names == _files(tmp_path / "b" / "d1")
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a" / "d1", tmp_path / "b" / "d1", names,
                                           shallow=False)
    assert not mismatch and not errors
    assert a["truth"] == b["truth"] and a["truth"] != c["truth"]


def test_panel_holds_the_parents_haplotypes_and_their_frequencies(tmp_path):
    d = data.write_pool_one(tmp_path, SMALL, 7, 0)
    for p in reads.panel_loci(d["panel"]):
        name = p["locus"].name
        parents = [h for s in d["samples"][:2] for h in d["truth"][name][s]]
        assert p["sequences"][0] == d["panels"][name]["sequences"][0]
        assert set(parents) <= set(p["sequences"])
        want = [parents.count(s) / 8 for s in p["sequences"]]
        np.testing.assert_allclose(p["frequencies"], want, atol=1e-4)


def test_reference_reads_the_written_reads(tmp_path):
    d = data.write_pool_one(tmp_path, SMALL, 11, 0)
    cell = run.load_cell("assemble.biparental")
    cell["samples"] = d["samples"]
    ref = run.load_tool(cell["tool"]).Reference(d, cell)
    assert [loc.name for loc in ref.loci] == list(d["truth"])
    for locus in ref.loci:
        for s in ref.samples:
            r = ref.sample_reads(locus, s)
            assert r.count == SMALL["reads_per_sample"] and r.depth == r.count
            assert r.counts.sum() == r.count
            # every read is one of the sample's true haplotypes, up to base errors
            truth = np.stack([reads.haplotype_alleles(locus, h) for h in d["truth"][locus.name][s]])
            mismatches = (r.calls[:, None, :] != truth[None]).sum(-1).min(-1)
            assert mismatches.mean() < 0.5


def test_every_seed_writes_the_same_pool_in_an_order_of_its_own(tmp_path):
    cell = dict(run.load_cell("call.biparental"), dataset=SMALL)
    a = run.write_pool(tmp_path / "a", cell, 3)
    b = run.write_pool(tmp_path / "b", cell, 3)
    assert [d["truth"] for d in a] == [d["truth"] for d in b]
    assert len({json.dumps(d["truth"], sort_keys=True) for d in a}) == 3
    for i in range(3):
        names = _files(tmp_path / "a" / f"d{i}")
        _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a" / f"d{i}", tmp_path / "b" / f"d{i}",
                                               names, shallow=False)
        assert not mismatch and not errors
    orders = {tuple(run.pool_order(seed, 3)) for seed in range(2**31, 2**31 + 40)}
    assert all(sorted(o) == [0, 1, 2] for o in orders) and len(orders) > 1
    assert run.pool_order(2**33 + 5, 3) == run.pool_order(2**33 + 5, 3)
