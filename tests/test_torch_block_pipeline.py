"""Every tool's loci through the one block loop, held byte-equal.

Each tool runs on the CPU at ``--locus-batch 3`` over 4 loci, so the
first block holds 3 loci and the second 1: a locus of 6 SNVs (one
triallelic), a locus with no SNV (the zero-variant case, whose trace
needs no launch), a locus of 5 SNVs, and, last, a second locus with no
SNV whose panel record is ``REFMASKED`` (filtered NOA by the tools that
read a panel).  The samples are 2 tetraploid parents and 2 F1, so
``call-pedigree`` runs on the same files.

The VCF of each case, less its ``##commandline`` and ``##fileDate``
lines, must equal the golden in ``tests/golden_torch/``, which commit
f85a51e wrote on the same files and seed.  The cases cover the routes
a block takes: ``assemble`` on K1 and on the torch de novo route (a
Dirichlet-multinomial prior with one sample at inbreeding 0), ``call``
flat (K2) and with a prior (the torch sampler), ``call-pedigree`` (K3)
and ``call-exact`` in one launch per block and, with GL and GP
reported, locus by locus.
"""

import contextlib
import io
import pathlib
import warnings

import pytest
import torch

from mchap_tpu_torch.application.cli import main
from mchap_tpu_torch.utils import fallback
from test_torch_fixtures import write_dataset, write_haplotype_vcf

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden_torch"
VOLATILE = ("##commandline", "##fileDate")
#: each case: its tool, its options, and the routes its launches take
#: (``utils/fallback.PATHS``) with how often: as at that commit, but for
#: ``call-pedigree``'s locus without SNVs, which took a launch of its own
#: there and takes its constant trace now
CASES = {
    "assemble": ("assemble", [], {("denovo", "plain"): 2}),
    "assemble.mixed-inbreeding": (
        "assemble", ["--use-dirmul-prior", "inbreeding"], {("denovo", "torch"): 2}),
    "call": ("call", [], {("calling", "plain"): 1}),
    "call.dirmul": ("call", ["--use-dirmul-prior", "0.1", "AFP"], {("calling", "torch"): 1}),
    "call-pedigree": ("call-pedigree", [], {("pedigree", "plain"): 1}),
    "call-exact": ("call-exact", [], {("call-exact", "block"): 1}),
    "call-exact.GL-GP": (
        "call-exact", ["--report", "GL", "GP"], {("call-exact", "per-locus"): 3}),
}


def _masked_last_record(path):
    """Flag the last record of a haplotype VCF ``REFMASKED``."""
    lines = pathlib.Path(path).read_text().splitlines()
    fields = lines[-1].split("\t")
    fields[7] += ";REFMASKED"
    lines[-1] = "\t".join(fields)
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
    return path


def write_inputs(directory):
    """The reads, targets and panels of every case, under ``directory``."""
    directory = pathlib.Path(directory)
    data = write_dataset(directory, n_samples=4, n_loci=4, snvs_per_locus=[6, 0, 5, 0],
                         reads_per_sample=24, error_rate=0.002, pedigree=True, seed=7)
    data["panel"] = _masked_last_record(write_haplotype_vcf(directory / "panel.vcf", data))
    data["panel_af"] = _masked_last_record(
        write_haplotype_vcf(directory / "panel_af.vcf", data, frequency_tag="AFP"))
    data["inbreeding"] = str(directory / "inbreeding.txt")
    pathlib.Path(data["inbreeding"]).write_text("".join(
        f"{s}\t{0.1 if i else 0.0}\n" for i, s in enumerate(data["samples"])))
    return data


def _argv(data, case):
    tool, extra, _ = CASES[case]
    argv = ["mchap", tool, "--bam", *data["bams"], "--ploidy", "4",
            "--reference", data["reference"], "--locus-batch", "3", "--device", "cpu"]
    if tool != "call-exact":
        argv += ["--mcmc-steps", "40", "--mcmc-burn", "10", "--mcmc-seed", "5"]
    if tool == "assemble":
        argv += ["--targets", data["targets"], "--variants", data["variants"]]
        extra = [data["inbreeding"] if x == "inbreeding" else x for x in extra]
    else:
        argv += ["--haplotypes", data["panel_af" if "AFP" in extra else "panel"]]
    if tool == "call-pedigree":
        argv += ["--sample-parents", data["pedigree"]]
    return argv + extra


def run_case(data, case):
    """The case's VCF, less its volatile lines."""
    out = io.StringIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # call-pedigree is experimental
        with contextlib.redirect_stdout(out):
            assert main(_argv(data, case)) == 0
    return [x for x in out.getvalue().splitlines() if not x.startswith(VOLATILE)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("block_pipeline"))


@pytest.mark.parametrize("case", list(CASES))
def test_block_vcf_matches_golden(inputs, case):
    fallback.PATHS.clear()
    got = run_case(inputs, case)
    assert dict(fallback.PATHS) == CASES[case][2]
    want = (GOLDEN / f"{case}.vcf").read_text().splitlines()
    records = [x for x in got if not x.startswith("#")]
    assert len(records) == 4
    assert got == want
