"""``mchap call-pedigree`` end to end: the port's CLI against ``mchap_tpu``'s.

Both run on the CPU on the same synthetic pedigree (2 tetraploid parents
and 3 Mendelian progeny, 3 loci, 24 reads per sample and locus) with the
parents' haplotype pool as the panel.  mchap_tpu runs its XLA sampler;
the port runs K3's plain version, or its torch joint sampler for
``--gamete-ibd``.  Their random streams differ, so the records must
agree on decisions: the same ALT and FILTER, the same GT wherever both
posteriors are decisive (GPM >= 0.6, the guard of
tests/test_application_call_pedigree.py), and PEDERR within 0.2 (a rate
over 2 chains x 40 kept steps).
"""

import contextlib
import io
import warnings

import pytest
import torch

from mchap_tpu.application.cli import main as jax_main
from mchap_tpu_torch.application.cli import main as torch_main
from mchap_tpu_torch.utils import fallback
from test_torch_fixtures import parse_vcf_records, write_dataset, write_haplotype_vcf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    directory = tmp_path_factory.mktemp("call_pedigree")
    data = write_dataset(directory, n_samples=5, n_loci=3, reads_per_sample=24,
                         error_rate=0.002, pedigree=True, seed=1)
    data["haplotypes"] = write_haplotype_vcf(directory / "haplotypes.vcf", data)
    return data


def _run(main, d, extra):
    argv = [
        "mchap", "call-pedigree", "--bam", *d["bams"], "--ploidy", "4",
        "--haplotypes", d["haplotypes"], "--reference", d["reference"],
        "--sample-parents", d["pedigree"], "--mcmc-steps", "60", "--mcmc-burn", "20",
        "--mcmc-seed", "3", *extra,
    ]
    out = io.StringIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the tool is experimental
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("extra,route", [
    ((), "plain"),
    (("--gamete-error", "0.5"), "plain"),
    (("--gamete-ibd", "0.1"), "torch"),
    (("--locus-batch", "2"), "plain"),
])
def test_call_pedigree_decisions_match_jax(dataset, extra, route):
    fallback.PATHS.clear()
    rc_t, vcf_t = _run(torch_main, dataset, ("--device", "cpu", *extra))
    assert set(fallback.PATHS) == {("pedigree", route)}
    rc_j, vcf_j = _run(jax_main, dataset, extra)
    assert rc_t == rc_j == 0
    got, want = parse_vcf_records(vcf_t), parse_vcf_records(vcf_j)
    assert len(got) == len(want) == 3
    decisive = 0
    for g, w in zip(got, want):
        for key in ("CHROM", "POS", "REF", "ALT", "FILTER"):
            assert g[key] == w[key], (key, g["ID"])
        for sample, call in g["calls"].items():
            other = w["calls"][sample]
            if float(call["GPM"]) >= 0.6 and float(other["GPM"]) >= 0.6:
                decisive += 1
                assert call["GT"] == other["GT"], (g["ID"], sample)
            assert abs(float(call["PEDERR"]) - float(other["PEDERR"])) < 0.2
    assert decisive >= 12  # of 15 sample-loci
