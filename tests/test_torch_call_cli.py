"""``mchap call`` end to end: the port's CLI against ``mchap_tpu``'s.

Both run on the CPU on the same synthetic SAM/FASTA inputs (3 tetraploid
samples, 3 loci, error-free amplicon reads) with each locus's founder
haplotypes as the panel, written as a haplotype VCF in ``mchap
assemble``'s output form.  mchap_tpu runs its XLA sampler, the port the
plain version of its CUDA calling kernel (flat prior) or its torch
sampler (``--use-dirmul-prior``).  Their random streams differ, so the
records must agree on decisions (CHROM, POS, REF, ALT, FILTER, every GT,
INFO AC/AN/NS), not bytes.
"""

import contextlib
import io

import pytest
import torch

from mchap_tpu.application.cli import main as jax_main
from mchap_tpu_torch.application.cli import main as torch_main
from mchap_tpu_torch.utils import fallback
from test_torch_fixtures import parse_vcf_records, write_dataset, write_haplotype_vcf

torch.set_num_threads(1)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    directory = tmp_path_factory.mktemp("call")
    data = write_dataset(directory, seed=0)
    data["haplotypes"] = write_haplotype_vcf(
        directory / "haplotypes.vcf", data, frequency_tag="AFP"
    )
    return data


def _argv(d, *extra):
    return [
        "mchap", "call", "--bam", *d["bams"], "--ploidy", "4",
        "--haplotypes", d["haplotypes"], "--reference", d["reference"],
        "--mcmc-steps", "300", "--mcmc-burn", "100", "--mcmc-seed", "3",
        *extra,
    ]


def _assert_same_decisions(vcf_t, vcf_j):
    got, want = parse_vcf_records(vcf_t), parse_vcf_records(vcf_j)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("CHROM", "POS", "REF", "ALT", "FILTER"):
            assert g[key] == w[key], (key, g["ID"])
        for key in ("AC", "AN", "NS"):
            assert g["INFO"][key] == w["INFO"][key], (key, g["ID"])
        assert {s: c["GT"] for s, c in g["calls"].items()} == {
            s: c["GT"] for s, c in w["calls"].items()
        }
    assert all(r["ALT"] != "." for r in got)
    return got


@pytest.mark.parametrize("locus_batch", ["1", "3"])
def test_call_decisions_match_jax(dataset, locus_batch):
    fallback.PATHS.clear()
    extra = ("--locus-batch", locus_batch)
    rc_t, vcf_t = _run(torch_main, _argv(dataset, "--device", "cpu", *extra))
    assert fallback.PATHS[("calling", "plain")] >= 1
    rc_j, vcf_j = _run(jax_main, _argv(dataset, *extra))
    assert rc_t == rc_j == 0
    got = _assert_same_decisions(vcf_t, vcf_j)
    for rec in got:
        assert all("." not in c["GT"] for c in rec["calls"].values())


def test_call_dirmul_prior_matches_jax(dataset):
    """``call`` supports ``--use-dirmul-prior`` (unlike ``assemble``): it
    runs the torch calling sampler and makes the JAX package's calls."""
    fallback.PATHS.clear()
    extra = ("--use-dirmul-prior", "0.1", "AFP", "--locus-batch", "3")
    rc_t, vcf_t = _run(torch_main, _argv(dataset, "--device", "cpu", *extra))
    assert fallback.PATHS[("calling", "torch")] >= 1
    assert fallback.PATHS[("calling", "plain")] == 0
    rc_j, vcf_j = _run(jax_main, _argv(dataset, *extra))
    assert rc_t == rc_j == 0
    _assert_same_decisions(vcf_t, vcf_j)
