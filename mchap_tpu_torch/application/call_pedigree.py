"""``mchap call-pedigree``: pedigree-informed joint genotype calling.

Reference: mchap/application/call_pedigree.py (experimental tool); port
of ``mchap_tpu/application/call_pedigree.py``.  Every locus of a block
runs through one launch of the pedigree sampler
(``models/pedigree.fit_pedigree_multi``): K3 at the defaults, the torch
joint sampler for double reduction, other gamete ploidies or
Metropolis-Hastings steps.  A failed block fails the run: nothing falls
back.
"""

import argparse
import sys
import warnings
from dataclasses import dataclass

import numpy as np

from mchap_tpu_torch.application import call_baseclass
from mchap_tpu_torch.application.arguments import (
    CALL_PEDIGREE_MCMC_PARSER_ARGUMENTS,
    collect_call_pedigree_mcmc_program_arguments,
)
from mchap_tpu_torch.application.baseclass import sample_errors
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.models.pedigree import fit_pedigree_multi, zero_variant_trace
from mchap_tpu_torch.utils import timing
from mchap_tpu_torch.utils.device import resolve_device


class ExperimentalFeatureWarning(UserWarning):
    pass


@dataclass
class program(call_baseclass.program):
    sample_parents: dict = None
    gamete_ploidy: dict = None
    gamete_ibd: dict = None
    gamete_error: dict = None
    mcmc_chains: int = 1
    mcmc_steps: int = 2000
    mcmc_burn: int = 1000
    mcmc_incongruence_threshold: float = 0.60

    @classmethod
    def cli(cls, command):
        warnings.warn(
            "THIS PROGRAM IS HIGHLY EXPERIMENTAL!!!", ExperimentalFeatureWarning
        )
        parser = argparse.ArgumentParser(
            "MCMC haplotype calling via pedigree-annealing. "
        )
        for arg in CALL_PEDIGREE_MCMC_PARSER_ARGUMENTS:
            arg.add_to(parser)
        if len(command) < 3:
            parser.print_help()
            sys.exit(1)
        args = parser.parse_args(command[2:])
        arguments = collect_call_pedigree_mcmc_program_arguments(args)
        arguments["device"] = resolve_device(arguments["device"])
        return cls(cli_command=command, **arguments)

    def _fill_invalid_sampledata(self, data):
        super()._fill_invalid_sampledata(data)
        for sample in data.samples:
            data.sampledata[VCF.FORMAT_PEDERR][sample] = np.nan

    def _padded_sample_reads(self, data):
        """Pad all samples' reads into one array (call_pedigree.py:138-150)."""
        n_samples = len(data.samples)
        max_reads = max(
            max((len(data.read_dists[s]) for s in data.samples), default=0), 1
        )
        n_pos = len(data.locus.positions)
        max_nucl = max([len(a) for a in data.locus.alleles] + [0])
        sample_reads = np.full((n_samples, max_reads, n_pos, max_nucl), np.nan)
        sample_read_counts = np.zeros((n_samples, max_reads), np.int64)
        for i, sample in enumerate(data.samples):
            _reads = data.read_dists[sample]
            _counts = data.read_counts[sample]
            sample_reads[i, 0 : len(_reads)] = _reads
            sample_read_counts[i, 0 : len(_counts)] = _counts
        return sample_reads, sample_read_counts

    def _pedigree_arrays(self, data):
        """Pedigree tables -> index arrays (call_pedigree.py:152-171);
        identical for every locus, so cached on the program."""
        cached = getattr(self, "_pedigree_arrays_cache", None)
        if cached is not None:
            return cached
        n_samples = len(data.samples)
        position = {s: i for i, s in enumerate(data.samples)}
        position[None] = -1
        sample_ploidy = np.array([data.sample_ploidy[s] for s in data.samples])
        parent_indices = np.full((n_samples, 2), -1, dtype=int)
        gamete_tau = np.full((n_samples, 2), -1, dtype=int)
        gamete_lambda = np.full((n_samples, 2), np.nan, dtype=float)
        gamete_error = np.full((n_samples, 2), np.nan, dtype=float)
        for i, s in enumerate(data.samples):
            for j, p in enumerate(self.sample_parents[s]):
                try:
                    parent_indices[i, j] = position[p]
                except KeyError as e:
                    raise KeyError(
                        "Parent identifier '{}' is not a sample identifier".format(p)
                    ) from e
            gamete_tau[i] = self.gamete_ploidy[s]
            gamete_lambda[i] = self.gamete_ibd[s]
            gamete_error[i] = self.gamete_error[s]
        cached = (
            sample_ploidy,
            parent_indices,
            gamete_tau,
            gamete_lambda,
            gamete_error,
        )
        object.__setattr__(self, "_pedigree_arrays_cache", cached)
        return cached

    def _fit_block(self, prepared):
        """Every locus of the block through ONE ``fit_pedigree_multi``
        call: the same pedigree runs at every locus, so the loci pad into
        a single batch.  A locus without SNVs takes the constant
        zero-variant trace, with no launch; a filtered locus takes
        nothing.  Returns each locus's burnt joint trace."""
        traces = {}
        problems = []
        indices = []
        arrays = None
        for idx, (data, setup) in enumerate(prepared):
            if setup is None:
                continue
            if arrays is None:
                arrays = self._pedigree_arrays(data)
            if setup["mcmc_haplotypes"].shape[1] == 0:
                traces[idx] = zero_variant_trace(
                    arrays[0], self.mcmc_chains, self.mcmc_steps
                ).burn(self.mcmc_burn)
                continue
            sample_reads, sample_read_counts = self._padded_sample_reads(data)
            problems.append(
                dict(
                    sample_reads=sample_reads,
                    sample_read_counts=sample_read_counts,
                    haplotypes=setup["mcmc_haplotypes"],
                    frequencies=setup["mcmc_prior_frequencies"],
                )
            )
            indices.append(idx)
        if not problems:
            return traces

        (sample_ploidy, parent_indices, gamete_tau, gamete_lambda,
         gamete_error) = arrays
        fitted = fit_pedigree_multi(
            problems,
            sample_ploidy=sample_ploidy,
            sample_parents=parent_indices,
            gamete_tau=gamete_tau,
            gamete_lambda=np.nan_to_num(gamete_lambda),
            gamete_error=np.nan_to_num(gamete_error, nan=1.0),
            steps=self.mcmc_steps,
            chains=self.mcmc_chains,
            random_seed=self.random_seed,
            burn=self.mcmc_burn,
            device=self.device,
        )
        timing.count(
            "sampler.steps",
            len(problems) * len(sample_ploidy) * self.mcmc_chains * self.mcmc_steps
        )
        for idx, t in zip(indices, fitted):
            traces[idx] = t.burn(self.mcmc_burn)
        return traces

    def _finish_locus(self, data, setup, pedigree_trace):
        """Posterior summarisation of every sample from the joint trace
        (reference call_pedigree.py:172-260): PEDERR, then each sample;
        a filtered locus was filled by ``_setup_locus``."""
        if setup is None:
            return
        (sample_ploidy, parent_indices, gamete_tau, gamete_lambda,
         _gamete_error) = self._pedigree_arrays(data)
        with timing.stage("pedigree.incongruence", locus=data.locus.name):
            pedigree_posterior_error = pedigree_trace.incongruence(
                sample_ploidy=sample_ploidy,
                sample_parents=parent_indices,
                gamete_tau=gamete_tau,
                gamete_lambda=np.nan_to_num(gamete_lambda),
            )
        with timing.stage("pedigree.posterior", locus=data.locus.name):
            for i, sample in enumerate(data.samples):
                with sample_errors(sample):
                    trace = pedigree_trace.individual(i)
                    self._finish_sample(data, sample, trace, setup)
                    data.sampledata[VCF.FORMAT_PEDERR][sample] = (
                        pedigree_posterior_error[i]
                    )
