"""Loci stream for known-haplotype callers; reference call_baseclass.py.

Port of ``mchap_tpu/application/call_baseclass.py``, with what the two
MCMC callers (``call``, ``call-pedigree``) share of the block loop's
hooks: the panel's masking and NOA/AF0 filters (``_setup_locus``) and
one sample's fields from its trace (``_finish_sample``).
"""

from dataclasses import dataclass

import numpy as np

from mchap_tpu_torch.application import baseclass
from mchap_tpu_torch.application.baseclass import ALT, FILTER, REF
from mchap_tpu_torch.encoding.integer import minimum_error_correction
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.loci import LocusPrior
from mchap_tpu_torch.io.util import qual_of_prob
from mchap_tpu_torch.io.vcflite import VariantFile
from mchap_tpu_torch.numerics.logprob import natural_log_to_log10
from mchap_tpu_torch.ops import exact


@dataclass
class program(baseclass.program):
    prior_frequencies_tag: str = None
    filter_input_haplotypes: str = None

    def loci(self):
        with VariantFile(self.vcf) as f:
            for record in f.fetch():
                yield LocusPrior.from_variant_record(
                    record,
                    frequency_tag=self.prior_frequencies_tag,
                    allele_filter=self.filter_input_haplotypes,
                )

    def _setup_locus(self, data):
        """Panel masking + invalid-scenario handling of the MCMC callers
        (reference call.py:49-118); returns the panel the sampler sees,
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
            self._fill_invalid_sampledata(data)
            return None
        if (prior_frequencies is not None) and np.any(np.isnan(prior_frequencies)):
            data.columndata[FILTER].append(VCF.AF0.id)
            self._fill_invalid_sampledata(data)
            return None
        return dict(
            haplotypes=haplotypes,
            mcmc_haplotypes=mcmc_haplotypes,
            mcmc_prior_frequencies=mcmc_prior_frequencies,
            mcmc_haplotype_labels=mcmc_haplotype_labels,
        )

    def _fill_invalid_sampledata(self, data):
        """All-nan sample fields for NOA/AF0 loci; reference call_exact.py:91-107."""
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

    def _finish_sample(self, data, sample, trace, setup):
        """One sample's fields from its burnt trace over the MCMC panel
        (reference call.py:149-199)."""
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
                device=self.device,
            ).cpu().numpy()
            data.sampledata[VCF.FORMAT_GL][sample] = natural_log_to_log10(llks)
