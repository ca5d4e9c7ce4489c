"""The port runs on the GPU unless asked for the CPU.

Every entry point defaults to ``cuda``; without a visible card it raises
instead of running on the CPU.  These tests need a machine without a
card and skip where CUDA is visible.
"""

import warnings

import numpy as np
import pytest
import torch

from mchap_tpu_torch.application.cli import main as torch_main
from mchap_tpu_torch.models import assemble, calling, pedigree
from mchap_tpu_torch.ops import exact
from mchap_tpu_torch.testing import simulate_reads
from mchap_tpu_torch.utils.device import resolve_device
from test_torch_fixtures import write_dataset, write_haplotype_vcf

torch.set_num_threads(1)

HAPS = np.array([[0, 0], [0, 1], [1, 1]], dtype=np.int8)
READS = simulate_reads(HAPS[[0, 1]], n_alleles=2, n_reads=4, seed=0)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the error path needs a machine without one")


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("auto")


def _sample_reads():
    sr = np.full((3, 4, 2, 2), np.nan)
    sr[:, :4] = READS
    return sr, np.ones((3, 4))


ENTRY_POINTS = {
    "DenovoMCMC": lambda: assemble.DenovoMCMC(ploidy=2, n_alleles=[2, 2], steps=2).fit(READS),
    "fit_denovo_multi": lambda: assemble.fit_denovo_multi(
        [dict(reads=READS, counts=np.ones(4), n_alleles=[2, 2])], 2, steps=2
    ),
    "CallingMCMC": lambda: calling.CallingMCMC(ploidy=2, haplotypes=HAPS, steps=2).fit(READS),
    "fit_calling_multi": lambda: calling.fit_calling_multi(
        [dict(reads=READS, counts=np.ones(4), haplotypes=HAPS)], 2, steps=2
    ),
    "PedigreeCallingMCMC": lambda: pedigree.PedigreeCallingMCMC(
        np.full(3, 2), np.array([[-1, -1], [-1, -1], [0, 1]]), np.ones((3, 2), int),
        np.zeros((3, 2)), np.full((3, 2), 0.01), HAPS, steps=2,
    ).fit(*_sample_reads()),
    "fit_pedigree_multi": lambda: pedigree.fit_pedigree_multi(
        [dict(zip(("sample_reads", "sample_read_counts"), _sample_reads()), haplotypes=HAPS)],
        np.full(3, 2), np.array([[-1, -1], [-1, -1], [0, 1]]), np.ones((3, 2), int),
        np.zeros((3, 2)), np.full((3, 2), 0.01), steps=2,
    ),
    "exact_posterior_stats_multi": lambda: exact.exact_posterior_stats_multi(
        [dict(reads=READS, counts=np.ones(4), haplotypes=HAPS)], 2
    ),
    "posterior_mode": lambda: exact.posterior_mode(READS, 2, HAPS),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_model_entry_points_default_to_cuda(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("tool", ["assemble", "call", "call-exact", "call-pedigree"])
def test_cli_defaults_to_cuda(no_card, tmp_path, tool):
    data = write_dataset(tmp_path, n_samples=3, n_loci=1, pedigree=True)
    argv = ["mchap", tool, "--bam", *data["bams"], "--ploidy", "4",
            "--reference", data["reference"]]
    if tool != "call-exact":
        argv += ["--mcmc-steps", "2", "--mcmc-burn", "0"]
    if tool == "assemble":
        argv += ["--targets", data["targets"], "--variants", data["variants"]]
    else:
        argv += ["--haplotypes", write_haplotype_vcf(tmp_path / "h.vcf", data)]
    if tool == "call-pedigree":
        argv += ["--sample-parents", data["pedigree"]]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # call-pedigree is experimental
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_main(argv)
