"""``call-exact``: the port's ``ops/exact.py`` and CLI against ``mchap_tpu``.

- Each ported ``exact`` function against JAX's in f64 on seeded inputs,
  rtol 1e-10: the prior of ``genotype_posteriors``, allele frequencies,
  the mode and its support, dosage alternatives, ``posterior_mode``, and
  ``exact_posterior_stats_multi`` with panel padding, panels of 1 and
  of 33 haplotypes and the Dirichlet-multinomial prior.
- ``mchap call-exact`` byte-equal to ``mchap_tpu``'s on ``write_dataset``
  data with a ``write_haplotype_vcf`` panel (the header lines naming the
  program, the date and the command excepted): the block path, ``--report
  GL GP`` (the per-locus path), a panel above 32 haplotypes, the
  Dirichlet-multinomial prior with a frequency tag, and an AF0 locus.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from mchap_tpu.application.cli import main as jax_main
from mchap_tpu.ops import exact as J
from mchap_tpu_torch.application.cli import main as torch_main
from mchap_tpu_torch.ops import exact as T
from mchap_tpu_torch.testing import simulate_reads
from mchap_tpu_torch.utils import fallback
from test_torch_fixtures import write_dataset, write_haplotype_vcf

torch.set_num_threads(1)

RTOL = 1e-10


def _case(rng, n_haps, ploidy, n_reads=12, n_pos=5):
    haps = rng.integers(0, 2, size=(n_haps, n_pos)).astype(np.int8)
    truth = haps[rng.integers(0, n_haps, ploidy)]
    reads = simulate_reads(truth, n_alleles=2, n_reads=n_reads, qual=(12, 25),
                           seed=int(rng.integers(1 << 30)))
    counts = rng.integers(1, 4, len(reads)).astype(float)
    return reads, counts, haps


@pytest.mark.parametrize("prior", [None, (0.0, None), (0.15, None), (0.15, "freqs")])
def test_posteriors_frequencies_and_mode_match_jax(prior):
    rng = np.random.default_rng(1)
    ploidy, n_haps = 4, 5
    reads, counts, haps = _case(rng, n_haps, ploidy)
    if prior is not None and prior[1] == "freqs":
        prior = (prior[0], rng.dirichlet(np.ones(n_haps)))
    llks_t = T.genotype_likelihoods(reads, ploidy, haps, counts)
    llks_j = J.genotype_likelihoods(reads, ploidy, haps, counts)
    np.testing.assert_allclose(llks_t.numpy(), np.asarray(llks_j), rtol=RTOL)
    post_t = T.genotype_posteriors(llks_t, ploidy, n_haps, prior=prior)
    post_j = J.genotype_posteriors(llks_j, ploidy, n_haps, prior=prior)
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), rtol=RTOL, atol=1e-300)
    for got, want in zip(T.posterior_allele_frequencies(post_t, ploidy, n_haps),
                         J.posterior_allele_frequencies(post_j, ploidy, n_haps)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    got, want = T.mode_genotype(post_t, ploidy, n_haps), J.mode_genotype(post_j, ploidy, n_haps)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose([float(got[1]), float(got[2])],
                               [float(want[1]), float(want[2])], rtol=RTOL)
    assert int(got[3]) == int(want[3])
    for g, w in zip(T.alternate_dosage_posteriors(got[0].numpy(), post_t.numpy()),
                    J.alternate_dosage_posteriors(np.asarray(want[0]), np.asarray(post_j))):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    for g, w in zip(T.posterior_mode(reads, ploidy, haps, counts, prior, True, True, True,
                                     device="cpu"),
                    J.posterior_mode(reads, ploidy, haps, counts, prior, True, True, True)):
        np.testing.assert_allclose(g, w, rtol=RTOL)


@pytest.mark.parametrize("ploidy,panels", [(4, [1, 3, 6, 2]), (2, [33, 1, 5])])
@pytest.mark.parametrize("use_prior", [False, True])
def test_exact_posterior_stats_multi_matches_jax(ploidy, panels, use_prior):
    """Panels of different sizes padded to one power of two, reads to one
    bucket; with the prior, some problems at F = 0 and some with their own
    frequencies."""
    rng = np.random.default_rng(ploidy + 10 * use_prior)
    problems = []
    for i, n_haps in enumerate(panels):
        reads, counts, haps = _case(rng, n_haps, ploidy, n_reads=6 + 5 * i, n_pos=7)
        problem = dict(reads=reads, counts=counts, haplotypes=haps)
        if use_prior:
            problem["inbreeding"] = [0.0, 0.2][i % 2]
            if i % 3 == 1:
                problem["frequencies"] = rng.dirichlet(np.ones(n_haps))
        problems.append(problem)
    got = T.exact_posterior_stats_multi(problems, ploidy, device="cpu")
    want = J.exact_posterior_stats_multi(problems, ploidy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["alleles"], np.asarray(w["alleles"]))
        for key in ("mode_prob", "support_prob", "freqs", "occur"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=key)


def test_stats_split_over_launches():
    """A block split over several launches gives what one launch gives."""
    rng = np.random.default_rng(3)
    problems = []
    for n_haps in (3, 4, 2, 4, 3):
        reads, counts, haps = _case(rng, n_haps, 4)
        problems.append(dict(reads=reads, counts=counts, haplotypes=haps))
    whole = T.exact_posterior_stats_multi(problems, 4, device="cpu")
    budget = T._problems_per_launch
    try:
        T._problems_per_launch = lambda *args: 2
        split = T.exact_posterior_stats_multi(problems, 4, device="cpu")
    finally:
        T._problems_per_launch = budget
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a["alleles"], b["alleles"])
        np.testing.assert_allclose(a["freqs"], b["freqs"], rtol=RTOL)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

VOLATILE = ("##fileDate", "##source", "##commandline")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = [x for x in out.getvalue().splitlines() if not x.startswith(VOLATILE)]
    return rc, lines


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("call_exact")
    d = write_dataset(root / "reads", seed=5)
    d["panel"] = write_haplotype_vcf(root / "panel.vcf", d)
    d["panel_af"] = write_haplotype_vcf(root / "panel_af.vcf", d, frequency_tag="AFP")
    # an AF0 locus: every prior frequency of the second record is 0
    lines = open(d["panel_af"]).read().splitlines()
    body = [i for i, x in enumerate(lines) if not x.startswith("#")]
    fields = lines[body[1]].split("\t")
    info = [("AFP=" + ",".join("0" for _ in kv.split(","))) if kv.startswith("AFP=")
            else kv for kv in fields[7].split(";")]
    lines[body[1]] = "\t".join(fields[:7] + [";".join(info)] + fields[8:])
    d["panel_af0"] = str(root / "panel_af0.vcf")
    open(d["panel_af0"], "w").write("\n".join(lines) + "\n")
    wide = write_dataset(root / "wide", n_loci=1, snvs_per_locus=12, n_founders=34,
                         n_triallelic=0, seed=6)
    wide["panel"] = write_haplotype_vcf(root / "wide.vcf", wide)
    d["wide"] = wide
    return d


def _argv(d, panel, *extra):
    return ["mchap", "call-exact", "--bam", *d["bams"], "--ploidy", "4",
            "--haplotypes", panel, *extra]


@pytest.mark.parametrize(
    "case",
    ["block", "GL GP", "panel above 32", "dirmul with AFP", "AF0 locus"],
)
def test_call_exact_cli_byte_equal(data, case):
    d, panel, extra = data, data["panel"], []
    route = "block"
    if case == "GL GP":
        extra, route = ["--report", "GL", "GP"], "per-locus"
    elif case == "panel above 32":
        d, panel, route = data["wide"], data["wide"]["panel"], "per-locus"
    elif case == "dirmul with AFP":
        panel, extra = data["panel_af"], ["--use-dirmul-prior", "0.1", "AFP"]
    elif case == "AF0 locus":
        panel, extra = data["panel_af0"], ["--use-dirmul-prior", "0.1", "AFP"]
    argv = _argv(d, panel, "--locus-batch", "3", *extra)
    fallback.PATHS.clear()
    rc_t, got = _run(torch_main, argv + ["--device", "cpu"])
    assert {path for site, path in fallback.PATHS if site == "call-exact"} == {route}
    rc_j, want = _run(jax_main, argv)
    assert rc_t == rc_j == 0
    assert len(want) > 20 and got == want
    if case == "AF0 locus":
        assert sum("AF0" in x for x in got if not x.startswith("#")) == 1


def test_failed_block_launch_raises(data, monkeypatch):
    """A failed block launch fails the run: no locus is retried on the
    per-locus path."""
    def fail(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(T, "exact_block_launch", fail)
    fallback.PATHS.clear()
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(torch_main, _argv(data, data["panel"], "--locus-batch", "3", "--device", "cpu"))
    assert ("call-exact", "per-locus") not in fallback.PATHS
