"""``--report GL`` computes the genotype likelihoods on the run's device.

``assemble``, ``call`` and ``call-pedigree`` each call
``ops/exact.genotype_likelihoods`` per sample when GL is reported; each
must pass the device the run was asked onto, as ``call-exact`` does, or
a card run computes GL on the CPU.  Here every tool runs with ``--device
cpu`` on a small dataset while a spy records the device argument of
every call.
"""

import contextlib
import io

import pytest
import torch

from mchap_tpu_torch.application.cli import main
from mchap_tpu_torch.ops import exact
from test_torch_fixtures import write_dataset, write_haplotype_vcf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    directory = tmp_path_factory.mktemp("gl_device")
    data = write_dataset(directory, n_samples=4, n_loci=1, snvs_per_locus=4,
                         n_triallelic=0, pedigree=True, seed=2)
    data["haplotypes"] = write_haplotype_vcf(directory / "haplotypes.vcf", data)
    return data


def _argv(tool, d):
    argv = ["mchap", tool, "--bam", *d["bams"], "--ploidy", "4",
            "--reference", d["reference"], "--mcmc-steps", "20", "--mcmc-burn", "5",
            "--report", "GL", "--device", "cpu"]
    if tool == "assemble":
        return argv + ["--targets", d["targets"], "--variants", d["variants"]]
    argv += ["--haplotypes", d["haplotypes"]]
    if tool == "call-pedigree":
        argv += ["--sample-parents", d["pedigree"]]
    return argv


@pytest.mark.parametrize("tool", ["assemble", "call", "call-pedigree"])
def test_gl_runs_on_the_run_device(dataset, monkeypatch, tool):
    devices, real = [], exact.genotype_likelihoods

    def spy(*args, **kw):
        devices.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(exact, "genotype_likelihoods", spy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(_argv(tool, dataset))
    assert rc == 0
    assert "GL" in out.getvalue().split("#CHROM")[0]
    assert devices and all(d == torch.device("cpu") for d in devices), devices
