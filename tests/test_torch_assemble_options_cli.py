"""``mchap assemble`` with a tempering ladder, the Dirichlet-multinomial
prior and both: the port's CLI against ``mchap_tpu``'s.

The same inputs as test_torch_assemble_cli.py.  mchap_tpu runs its XLA
sampler, the port the plain version of K1 in its tempered and prior
modes.  The records must agree on decisions, with alleles named by their
sequences (ALT alleles of equal pooled weight may come in either order).
"""

import pytest
import torch

from mchap_tpu.application.cli import main as jax_main
from mchap_tpu_torch.application.cli import main as torch_main
from test_torch_assemble_cli import _argv, _run
from test_torch_fixtures import called_haplotypes, parse_vcf_records, write_dataset

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("assemble_options"), seed=0)


TEMPERED = ["--mcmc-temperatures", "0.5", "1.0"]
DIRMUL = ["--use-dirmul-prior", "0.1"]


def _decisions(record):
    """A record's decisions with alleles named by their sequences."""
    alleles = [record["REF"]] + (
        record["ALT"].split(",") if record["ALT"] != "." else []
    )
    counts = record["INFO"]["AC"].split(",") if len(alleles) > 1 else []
    return dict(
        site=(record["CHROM"], record["POS"], record["REF"], record["FILTER"]),
        alts=sorted(alleles[1:]),
        an_ns=(record["INFO"]["AN"], record["INFO"]["NS"]),
        ac=dict(zip(alleles[1:], counts)),
        calls=called_haplotypes(record),
    )


@pytest.mark.parametrize(
    "extra", [TEMPERED, DIRMUL, TEMPERED + DIRMUL], ids=["tempered", "dirmul", "both"]
)
def test_assemble_options_match_jax(dataset, extra):
    rc_t, vcf_t = _run(torch_main, _argv(dataset, "--device", "cpu", *extra))
    rc_j, vcf_j = _run(jax_main, _argv(dataset, *extra))
    assert rc_t == rc_j == 0
    got, want = parse_vcf_records(vcf_t), parse_vcf_records(vcf_j)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _decisions(g) == _decisions(w), g["ID"]
    assert any(r["ALT"] != "." for r in got)
