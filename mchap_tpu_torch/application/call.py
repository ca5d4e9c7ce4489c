"""``mchap call``: MCMC genotype calling over known haplotypes.

Reference: mchap/application/call.py; port of
``mchap_tpu/application/call.py``.  At the defaults (flat prior, Gibbs)
every (locus, sample) problem of a block runs through one launch of the
calling sampler (K2, ``ops/cuda_calling.py``); ``--use-dirmul-prior``
runs the batched torch sampler (``ops/calling_mcmc.py``).  A failed block
fails the run: nothing falls back to a per-locus path.
"""

import argparse
import sys
from dataclasses import dataclass

import numpy as np

from mchap_tpu_torch.application import call_baseclass
from mchap_tpu_torch.application.arguments import (
    CALL_MCMC_PARSER_ARGUMENTS,
    collect_call_mcmc_program_arguments,
)
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
from mchap_tpu_torch.models.calling import (
    CallingMCMC,
    fit_calling_batch,
    fit_calling_multi,
)
from mchap_tpu_torch.numerics.logprob import natural_log_to_log10
from mchap_tpu_torch.ops import exact
from mchap_tpu_torch.utils import timing
from mchap_tpu_torch.utils.device import resolve_device


def _fill_invalid_sampledata(data):
    """All-nan sample fields for NOA/AF0 loci; reference call_exact.py:91-107.

    A copy of ``mchap_tpu/application/call_exact.py::_fill_invalid_sampledata``.
    """
    for sample in data.samples:
        ploidy = data.sample_ploidy[sample]
        data.sampledata[VCF.FORMAT_GT][sample] = np.full(ploidy, -1, int)
        for f in (
            VCF.FORMAT_GQ,
            VCF.FORMAT_GPM,
            VCF.FORMAT_SPM,
            VCF.FORMAT_SQ,
            VCF.FORMAT_MCI,
            VCF.FORMAT_MEC,
            VCF.FORMAT_MECP,
        ):
            data.sampledata[f][sample] = np.nan
        for f in (
            VCF.FORMAT_ACP,
            VCF.FORMAT_AFP,
            VCF.FORMAT_AOP,
            VCF.FORMAT_GP,
            VCF.FORMAT_GL,
        ):
            data.sampledata[f][sample] = np.array([np.nan])


def _locus_error(locus):
    return LOCUS_ASSEMBLY_ERROR.format(
        name=locus.name, contig=locus.contig, start=locus.start, stop=locus.stop
    )


@dataclass
class program(call_baseclass.program):
    mcmc_chains: int = 1
    mcmc_steps: int = 2000
    mcmc_burn: int = 1000
    mcmc_incongruence_threshold: float = 0.60

    @classmethod
    def cli(cls, command):
        parser = argparse.ArgumentParser("MCMC haplotype calling")
        for arg in CALL_MCMC_PARSER_ARGUMENTS:
            arg.add_to(parser)
        if len(command) < 3:
            parser.print_help()
            sys.exit(1)
        args = parser.parse_args(command[2:])
        arguments = collect_call_mcmc_program_arguments(args)
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

        # mask zero-frequency haplotypes out of the MCMC
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
            return None
        if (prior_frequencies is not None) and np.any(np.isnan(prior_frequencies)):
            data.columndata[FILTER].append(VCF.AF0.id)
            _fill_invalid_sampledata(data)
            return None
        return dict(
            haplotypes=haplotypes,
            mcmc_haplotypes=mcmc_haplotypes,
            mcmc_prior_frequencies=mcmc_prior_frequencies,
            mcmc_haplotype_labels=mcmc_haplotype_labels,
        )

    def _finish_sample(self, data, sample, trace, setup):
        """Posterior summarisation of one sample's trace (call.py:149-199)."""
        haplotypes = setup["haplotypes"]
        read_calls = data.read_calls[sample]
        if setup["mcmc_haplotype_labels"] is not None:
            trace = trace.relabel(setup["mcmc_haplotype_labels"])
        incongruence = trace.replicate_incongruence(
            threshold=self.mcmc_incongruence_threshold
        )
        posterior = trace.posterior()
        alleles, genotype_prob, genotype_support_prob = posterior.mode(
            genotype_support=True
        )

        data.sampledata[VCF.FORMAT_GT][sample] = alleles
        data.sampledata[VCF.FORMAT_GQ][sample] = qual_of_prob(genotype_prob)
        data.sampledata[VCF.FORMAT_GPM][sample] = float(genotype_prob)
        data.sampledata[VCF.FORMAT_SPM][sample] = float(genotype_support_prob)
        data.sampledata[VCF.FORMAT_SQ][sample] = qual_of_prob(genotype_support_prob)
        data.sampledata[VCF.FORMAT_MCI][sample] = incongruence
        mec = np.sum(minimum_error_correction(read_calls, haplotypes[alleles]))
        mec_denom = np.sum(read_calls >= 0)
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
            data.sampledata[VCF.FORMAT_GL][sample] = natural_log_to_log10(llks)

    def _sample_prior(self, data, setup, sample):
        if data.sample_inbreeding is None:
            return None
        return data.sample_inbreeding[sample], setup["mcmc_prior_frequencies"]

    def _fit_sample_trace(self, data, setup, sample):
        """One sampler run for one sample (reference call.py:120-148)."""
        return (
            CallingMCMC(
                ploidy=data.sample_ploidy[sample],
                haplotypes=setup["mcmc_haplotypes"],
                prior=self._sample_prior(data, setup, sample),
                steps=self.mcmc_steps,
                chains=self.mcmc_chains,
                random_seed=self.random_seed,
                device=self.device,
            )
            .fit(
                reads=data.read_dists[sample],
                read_counts=data.read_counts[sample],
            )
            .burn(self.mcmc_burn)
        )

    def call_sample_genotypes(self, data):
        """MCMC call per sample; reference call.py:49-199."""
        setup = self._setup_locus(data)
        if setup is None:
            return data

        # one batched launch covers every sample when their ploidies
        # agree; otherwise each sample runs on its own
        ploidies = [data.sample_ploidy[s] for s in data.samples]
        batch_traces = {}
        if len(set(ploidies)) == 1 and len(data.samples) > 1:
            traces = fit_calling_batch(
                ploidy=ploidies[0],
                haplotypes=setup["mcmc_haplotypes"],
                reads_list=[data.read_dists[s] for s in data.samples],
                counts_list=[data.read_counts[s] for s in data.samples],
                inbreeding_list=(
                    None
                    if data.sample_inbreeding is None
                    else [data.sample_inbreeding[s] for s in data.samples]
                ),
                frequencies=(
                    None
                    if data.sample_inbreeding is None
                    else setup["mcmc_prior_frequencies"]
                ),
                steps=self.mcmc_steps,
                chains=self.mcmc_chains,
                random_seed=self.random_seed,
                burn=self.mcmc_burn,
                device=self.device,
            )
            timing.count_sampler_steps(
                len(data.samples) * self.mcmc_chains * self.mcmc_steps
            )
            batch_traces = dict(zip(data.samples, traces))

        for sample in data.samples:
            try:
                if sample in batch_traces:
                    trace = batch_traces[sample].burn(self.mcmc_burn)
                else:
                    trace = self._fit_sample_trace(data, setup, sample)
                self._finish_sample(data, sample, trace, setup)
            except Exception as e:
                message = SAMPLE_ASSEMBLY_ERROR.format(sample=sample)
                raise SampleAssemblyError(message) from e
        return data

    def _call_locus_block(self, loci):
        """Call a block of loci with one sampler launch per ploidy group.

        Every (locus, sample) problem of the block is padded into one
        batch (models/calling.py ``fit_calling_multi``).  The reference
        parallelises the same axis with one forked process per locus
        (baseclass.py:360-394).  Returns formatted VCF lines in input
        order.
        """
        prepared = []
        with timing.stage("encode_reads"):
            for locus in loci:
                try:
                    data = self._locus_data(locus, self.sample_bams)
                    self.encode_sample_reads(data)
                    setup = self._setup_locus(data)
                except Exception as e:
                    raise LocusAssemblyError(_locus_error(locus)) from e
                prepared.append((locus, data, setup))

        groups = {}
        for idx, (locus, data, setup) in enumerate(prepared):
            if setup is None or setup["mcmc_haplotypes"].shape[1] == 0:
                continue  # filtered locus or zero-variant shortcut
            for sample in data.samples:
                problem = dict(
                    reads=data.read_dists[sample],
                    counts=data.read_counts[sample],
                    haplotypes=setup["mcmc_haplotypes"],
                )
                if data.sample_inbreeding is not None:
                    problem["inbreeding"] = data.sample_inbreeding[sample]
                    problem["frequencies"] = setup["mcmc_prior_frequencies"]
                groups.setdefault(data.sample_ploidy[sample], []).append(
                    (idx, sample, problem)
                )

        traces = {}
        with timing.stage("device_sampler"):
            for ploidy, items in groups.items():
                fitted = fit_calling_multi(
                    [p for _, _, p in items],
                    ploidy,
                    steps=self.mcmc_steps,
                    chains=self.mcmc_chains,
                    random_seed=self.random_seed,
                    burn=self.mcmc_burn,
                    device=self.device,
                )
                timing.count_sampler_steps(
                    len(items) * self.mcmc_chains * self.mcmc_steps
                )
                for (idx, sample, _), t in zip(items, fitted):
                    traces[(idx, sample)] = t

        results = []
        with timing.stage("summarize_format"):
            for idx, (locus, data, setup) in enumerate(prepared):
                try:
                    if setup is not None:
                        for sample in data.samples:
                            try:
                                t = traces.get((idx, sample))
                                if t is not None:
                                    trace = t.burn(self.mcmc_burn)
                                else:  # zero-variant locus
                                    trace = self._fit_sample_trace(
                                        data, setup, sample
                                    )
                                self._finish_sample(data, sample, trace, setup)
                            except Exception as e:
                                message = SAMPLE_ASSEMBLY_ERROR.format(
                                    sample=sample
                                )
                                raise SampleAssemblyError(message) from e
                    self.sumarise_vcf_record(data)
                    results.append(data.format_vcf_record())
                except Exception as e:
                    raise LocusAssemblyError(_locus_error(locus)) from e
                timing.tick_loci(1, sample_calls=len(data.samples))
        return results
