"""``mchap assemble`` end to end: the port's CLI against ``mchap_tpu``'s.

Both run on the CPU on the same synthetic SAM/VCF/FASTA/BED inputs (3
tetraploid samples, 3 loci of 8 SNVs, one triallelic SNV, error-free
amplicon reads): mchap_tpu with its XLA sampler, the port with the plain
version of its CUDA kernel.  Their random streams differ, so the records
must agree on decisions (CHROM, POS, REF, ALT, FILTER, every GT, INFO
AC/AN/NS), not bytes.  The tempering ladder and the Dirichlet-multinomial
prior are in test_torch_assemble_options_cli.py.
"""

import contextlib
import io

import pytest
import torch

from mchap_tpu.application.cli import main as jax_main
from mchap_tpu_torch.application.cli import main as torch_main
from test_torch_fixtures import parse_vcf_records, write_dataset

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("assemble"), seed=0)


def _argv(d, *extra):
    return [
        "mchap", "assemble", "--bam", *d["bams"], "--ploidy", "4",
        "--targets", d["targets"], "--variants", d["variants"],
        "--reference", d["reference"], "--mcmc-steps", "300",
        "--mcmc-burn", "100", "--mcmc-seed", "3", "--locus-batch", "3",
        *extra,
    ]


def test_assemble_decisions_match_jax(dataset):
    rc_t, vcf_t = _run(torch_main, _argv(dataset, "--device", "cpu"))
    rc_j, vcf_j = _run(jax_main, _argv(dataset))
    assert rc_t == rc_j == 0
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
    # the triallelic SNV and the alternate haplotypes are exercised
    assert any(r["ALT"] != "." for r in got)


@pytest.mark.parametrize(
    "extra",
    [["--mcmc-temperatures", *[f"{0.1 * i:.1f}" for i in range(2, 10)]],
     ["--ploidy", "13"], ["mixed-inbreeding"]],
)
def test_k1_refused_options_match_jax(dataset, extra, tmp_path):
    """What K1 cannot run (9 rungs, ploidy 13, a prior with some samples
    at inbreeding 0) takes the torch de novo route (on the CPU its plain
    version) and reaches mchap_tpu's decisions (GT and ALT, alleles named by sequence).

    Ploidy 13 runs on data drawn at ploidy 13 (1 locus of 3 biallelic SNVs,
    520 reads per sample), where the dosage of each haplotype is clear;
    the tetraploid dataset would leave it to sampling noise."""
    from test_torch_assemble_options_cli import _decisions

    from mchap_tpu_torch.utils import fallback

    if extra == ["--ploidy", "13"]:
        dataset = write_dataset(tmp_path, ploidy=13, reads_per_sample=520, n_loci=1,
                                snvs_per_locus=3, n_triallelic=0, seed=0)
    if extra == ["mixed-inbreeding"]:
        path = tmp_path / "inbreeding.txt"
        path.write_text("".join(
            f"{s}\t{0.1 if i else 0.0}\n" for i, s in enumerate(dataset["samples"])
        ))
        extra = ["--use-dirmul-prior", str(path)]
    extra = [*extra, "--mcmc-steps", "80", "--mcmc-burn", "20"]
    fallback.PATHS.clear()
    rc_t, vcf_t = _run(torch_main, _argv(dataset, "--device", "cpu", *extra))
    assert {path for site, path in fallback.PATHS if site == "denovo"} == {"torch"}
    rc_j, vcf_j = _run(jax_main, _argv(dataset, *extra))
    assert rc_t == rc_j == 0
    got, want = parse_vcf_records(vcf_t), parse_vcf_records(vcf_j)
    assert len(got) == len(want) == len(dataset["truth"])
    for g, w in zip(got, want):
        assert _decisions(g)["calls"] == _decisions(w)["calls"], g["ID"]
        assert _decisions(g)["alts"] == _decisions(w)["alts"], g["ID"]


def test_tools_parse_help(capsys):
    """An unknown tool exits 2; call-exact, find-snvs and atomize, which
    the port now runs, parse --help."""
    assert torch_main(["mchap", "bogus"]) == 2
    assert "unknown tool" in capsys.readouterr().err
    for tool in ("call-exact", "find-snvs", "atomize"):
        with pytest.raises(SystemExit) as exit_:
            torch_main(["mchap", tool, "--help"])
        assert exit_.value.code == 0
        assert "usage" in capsys.readouterr().out
