"""``mchap call-pedigree``: pedigree-informed joint genotype calling.

Reference: mchap/application/call_pedigree.py (experimental tool); port
of ``mchap_tpu/application/call_pedigree.py``.  Every locus of a block
runs through one launch of the pedigree sampler
(``models/pedigree.fit_pedigree_multi``): K3 at the defaults, the torch
joint sampler for double reduction, other gamete ploidies or
Metropolis-Hastings steps.  A failed block fails the run: nothing falls
back to a per-locus path.
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
from mchap_tpu_torch.application.call import _fill_invalid_sampledata
from mchap_tpu_torch.application.baseclass import (
    ALT,
    FILTER,
    LOCUS_ASSEMBLY_ERROR,
    REF,
    SAMPLE_ASSEMBLY_ERROR,
    LocusAssemblyError,
    SampleAssemblyError,
)
from mchap_tpu_torch.encoding.integer import minimum_error_correction
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.util import qual_of_prob
from mchap_tpu_torch.models.pedigree import PedigreeCallingMCMC, fit_pedigree_multi
from mchap_tpu_torch.numerics.logprob import natural_log_to_log10
from mchap_tpu_torch.ops import exact
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

    def _setup_locus(self, data):
        """Panel masking + invalid-scenario handling; returns a setup dict
        or None when the locus is filtered (NOA/AF0)."""
        haplotypes = data.locus.encode_haplotypes()
        prior_frequencies = data.locus.frequencies
        mask_reference_allele = data.locus.mask_reference_allele
        mask = np.zeros(len(haplotypes), bool)
        mask[0] = mask_reference_allele

        data.columndata[REF] = data.locus.sequence
        data.columndata[ALT] = data.locus.alts
        data.infodata[VCF.INFO_REFMASKED] = mask_reference_allele
        data.infodata[VCF.INFO_AFPRIOR] = prior_frequencies

        mask |= prior_frequencies == 0
        if np.any(mask):
            mcmc_haplotypes = haplotypes[~mask]
            mcmc_prior_frequencies = prior_frequencies[~mask]
            mcmc_haplotype_labels = np.where(~mask)[0]
        else:
            mcmc_haplotype_labels = None
            mcmc_prior_frequencies = prior_frequencies
            mcmc_haplotypes = haplotypes

        if len(mcmc_haplotypes) == 0:
            data.columndata[FILTER].append(VCF.NOA.id)
            _fill_invalid_sampledata(data)
            for sample in data.samples:
                data.sampledata[VCF.FORMAT_PEDERR][sample] = np.nan
            return None
        if (prior_frequencies is not None) and np.any(np.isnan(prior_frequencies)):
            data.columndata[FILTER].append(VCF.AF0.id)
            _fill_invalid_sampledata(data)
            for sample in data.samples:
                data.sampledata[VCF.FORMAT_PEDERR][sample] = np.nan
            return None
        return dict(
            haplotypes=haplotypes,
            mcmc_haplotypes=mcmc_haplotypes,
            mcmc_prior_frequencies=mcmc_prior_frequencies,
            mcmc_haplotype_labels=mcmc_haplotype_labels,
        )

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

    def call_sample_genotypes(self, data):
        """Joint pedigree MCMC call; reference call_pedigree.py:63-260."""
        setup = self._setup_locus(data)
        if setup is None:
            return data

        sample_reads, sample_read_counts = self._padded_sample_reads(data)
        (sample_ploidy, parent_indices, gamete_tau, gamete_lambda,
         gamete_error) = self._pedigree_arrays(data)

        pedigree_trace = (
            PedigreeCallingMCMC(
                sample_ploidy=sample_ploidy,
                sample_parents=parent_indices,
                gamete_tau=gamete_tau,
                gamete_lambda=np.nan_to_num(gamete_lambda),
                gamete_error=np.nan_to_num(gamete_error, nan=1.0),
                haplotypes=setup["mcmc_haplotypes"],
                frequencies=setup["mcmc_prior_frequencies"],
                steps=self.mcmc_steps,
                annealing=self.mcmc_burn,
                chains=self.mcmc_chains,
                random_seed=self.random_seed,
                device=self.device,
            )
            .fit(sample_reads=sample_reads, sample_read_counts=sample_read_counts)
            .burn(self.mcmc_burn)
        )
        return self._finish_locus(data, setup, pedigree_trace)

    def _finish_locus(self, data, setup, pedigree_trace):
        """Posterior summarisation of every sample from the joint trace
        (reference call_pedigree.py:172-260)."""
        haplotypes = setup["haplotypes"]
        mcmc_haplotype_labels = setup["mcmc_haplotype_labels"]
        (sample_ploidy, parent_indices, gamete_tau, gamete_lambda,
         _gamete_error) = self._pedigree_arrays(data)
        pedigree_posterior_error = pedigree_trace.incongruence(
            sample_ploidy=sample_ploidy,
            sample_parents=parent_indices,
            gamete_tau=gamete_tau,
            gamete_lambda=np.nan_to_num(gamete_lambda),
        )

        for i, sample in enumerate(data.samples):
            try:
                trace = pedigree_trace.individual(i)
                if mcmc_haplotype_labels is not None:
                    trace = trace.relabel(mcmc_haplotype_labels)
                incongruence = trace.replicate_incongruence(
                    threshold=self.mcmc_incongruence_threshold
                )
                posterior = trace.posterior()
                alleles, genotype_prob, support_prob = posterior.mode(
                    genotype_support=True
                )
                data.sampledata[VCF.FORMAT_GT][sample] = alleles
                data.sampledata[VCF.FORMAT_GQ][sample] = qual_of_prob(genotype_prob)
                data.sampledata[VCF.FORMAT_GPM][sample] = float(genotype_prob)
                data.sampledata[VCF.FORMAT_SPM][sample] = float(support_prob)
                data.sampledata[VCF.FORMAT_SQ][sample] = qual_of_prob(support_prob)
                data.sampledata[VCF.FORMAT_MCI][sample] = incongruence
                data.sampledata[VCF.FORMAT_PEDERR][sample] = pedigree_posterior_error[i]
                _read_calls = data.read_calls[sample]
                mec = np.sum(
                    minimum_error_correction(_read_calls, haplotypes[alleles])
                )
                mec_denom = np.sum(_read_calls >= 0)
                data.sampledata[VCF.FORMAT_MEC][sample] = mec
                data.sampledata[VCF.FORMAT_MECP][sample] = (
                    mec / mec_denom if mec_denom > 0 else np.nan
                )
                if self.require_AFP():
                    frequencies, counts, occurrence = trace.posterior_frequencies()
                    data.sampledata[VCF.FORMAT_ACP][sample] = counts
                    data.sampledata[VCF.FORMAT_AFP][sample] = frequencies
                    data.sampledata[VCF.FORMAT_AOP][sample] = occurrence
                if VCF.FORMAT_GP in data.formatfields:
                    data.sampledata[VCF.FORMAT_GP][sample] = posterior.as_array(
                        len(haplotypes)
                    )
                if VCF.FORMAT_GL in data.formatfields:
                    llks = exact.genotype_likelihoods(
                        data.read_dists[sample],
                        data.sample_ploidy[sample],
                        haplotypes,
                        data.read_counts[sample],
                    ).numpy()
                    data.sampledata[VCF.FORMAT_GL][sample] = np.asarray(
                        natural_log_to_log10(llks)
                    )
            except Exception as e:
                message = SAMPLE_ASSEMBLY_ERROR.format(sample=sample)
                raise SampleAssemblyError(message) from e
        return data

    def _call_locus_block(self, loci):
        """Call a block of loci with ONE joint-pedigree device program.

        Cross-locus streaming: the same pedigree runs at every locus, so
        the loci pad into a single vmapped batch
        (models/pedigree.py ``fit_pedigree_multi``) instead of one
        device round-trip per locus — the axis the reference
        parallelises with forked processes (baseclass.py:360-394).
        Returns formatted VCF record lines in input order.
        """
        prepared = []
        with timing.stage("encode_reads"):
            for locus in loci:
                try:
                    data = self._locus_data(locus, self.sample_bams)
                    self.encode_sample_reads(data)
                    setup = self._setup_locus(data)
                except Exception as e:
                    message = LOCUS_ASSEMBLY_ERROR.format(
                        name=locus.name,
                        contig=locus.contig,
                        start=locus.start,
                        stop=locus.stop,
                    )
                    raise LocusAssemblyError(message) from e
                prepared.append((locus, data, setup))

        problems = []
        indices = []
        arrays = None
        for idx, (locus, data, setup) in enumerate(prepared):
            if setup is None or setup["mcmc_haplotypes"].shape[1] == 0:
                continue  # filtered locus or zero-variant shortcut
            sample_reads, sample_read_counts = self._padded_sample_reads(data)
            if arrays is None:
                arrays = self._pedigree_arrays(data)
            problems.append(
                dict(
                    sample_reads=sample_reads,
                    sample_read_counts=sample_read_counts,
                    haplotypes=setup["mcmc_haplotypes"],
                    frequencies=setup["mcmc_prior_frequencies"],
                )
            )
            indices.append(idx)

        traces = {}
        with timing.stage("device_sampler"):
            if problems:
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
                timing.count_sampler_steps(
                    len(problems)
                    * len(sample_ploidy)
                    * self.mcmc_chains
                    * self.mcmc_steps
                )
                for idx, t in zip(indices, fitted):
                    traces[idx] = t.burn(self.mcmc_burn)

        results = []
        with timing.stage("summarize_format"):
            for idx, (locus, data, setup) in enumerate(prepared):
                try:
                    if setup is not None:
                        trace = traces.get(idx)
                        if trace is not None:
                            self._finish_locus(data, setup, trace)
                        else:  # zero-variant locus
                            self.call_sample_genotypes(data)
                    self.sumarise_vcf_record(data)
                    results.append(data.format_vcf_record())
                except Exception as e:
                    message = LOCUS_ASSEMBLY_ERROR.format(
                        name=locus.name,
                        contig=locus.contig,
                        start=locus.start,
                        stop=locus.stop,
                    )
                    raise LocusAssemblyError(message) from e
                timing.tick_loci(1, sample_calls=len(data.samples))
        return results
