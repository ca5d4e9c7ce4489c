"""``mchap call-exact``: exact-enumeration genotype calling.

Reference: mchap/application/call_exact.py; port of
``mchap_tpu/application/call_exact.py``.  Fully deterministic, so its
output is byte-comparable to ``mchap_tpu``'s.  Each locus's route is
chosen before any device work: the block path (every sample of every
block locus through ``exact.exact_posterior_stats_multi``) or the
per-locus path (panels above ``MAX_BLOCK_PANEL``, dense GL/GP fields).
A failed block launch fails the run: nothing is retried per locus.
"""

import argparse
import sys
from dataclasses import dataclass

import numpy as np

from mchap_tpu_torch.application import call_baseclass
from mchap_tpu_torch.application.arguments import (
    CALL_EXACT_PARSER_ARGUMENTS,
    collect_call_exact_program_arguments,
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
from mchap_tpu_torch.numerics.combinadics import index_as_genotype_alleles_np
from mchap_tpu_torch.numerics.logprob import natural_log_to_log10
from mchap_tpu_torch.ops import exact
from mchap_tpu_torch.utils import fallback, timing
from mchap_tpu_torch.utils.device import resolve_device

# panels above this size take the per-locus path inside a block: the
# padded VCF genotype table would grow past C(32+3, 4) rows per problem
MAX_BLOCK_PANEL = 32


@dataclass
class program(call_baseclass.program):
    @classmethod
    def cli(cls, command):
        parser = argparse.ArgumentParser("Exact haplotype calling")
        for arg in CALL_EXACT_PARSER_ARGUMENTS:
            arg.add_to(parser)
        if len(command) < 3:
            parser.print_help()
            sys.exit(1)
        args = parser.parse_args(command[2:])
        arguments = collect_call_exact_program_arguments(args)
        arguments["device"] = resolve_device(arguments["device"])
        return cls(cli_command=command, **arguments)

    def _setup_locus(self, data):
        """Header fields + invalid-scenario detection.

        Returns (haplotypes, prior_frequencies, invalid); on an invalid
        locus the NOA/AF0 filter has been appended (reference
        call_exact.py:52-90).
        """
        haplotypes = data.locus.encode_haplotypes()
        mask_reference_allele = data.locus.mask_reference_allele
        prior_frequencies = data.locus.frequencies

        data.columndata[REF] = data.locus.sequence
        data.columndata[ALT] = data.locus.alts
        data.infodata[VCF.INFO_REFMASKED] = mask_reference_allele
        data.infodata[VCF.INFO_AFPRIOR] = prior_frequencies

        if mask_reference_allele:
            assert (prior_frequencies[0] == 0) or np.isnan(prior_frequencies[0])

        if mask_reference_allele and len(haplotypes) == 1:
            invalid_scenario = True
            data.columndata[FILTER].append(VCF.NOA.id)
        elif np.any(np.isnan(prior_frequencies)):
            invalid_scenario = True
            data.columndata[FILTER].append(VCF.AF0.id)
        else:
            invalid_scenario = False
        return haplotypes, prior_frequencies, invalid_scenario

    def call_sample_genotypes(self, data):
        """Exact posterior call per sample; reference call_exact.py:52-199."""
        haplotypes, prior_frequencies, invalid_scenario = self._setup_locus(
            data
        )
        if invalid_scenario:
            _fill_invalid_sampledata(data)
            return data
        fallback.note_path("call-exact", "per-locus")

        for sample in data.samples:
            try:
                ploidy = data.sample_ploidy[sample]
                read_calls = data.read_calls[sample]
                read_dists = data.read_dists[sample]
                read_counts = data.read_counts[sample]

                if data.sample_inbreeding is None:
                    prior = None
                else:
                    prior = (data.sample_inbreeding[sample], prior_frequencies)

                if (VCF.FORMAT_GL in data.formatfields) or (
                    VCF.FORMAT_GP in data.formatfields
                ):
                    llks = exact.genotype_likelihoods(
                        read_dists, ploidy, haplotypes, read_counts,
                        device=self.device,
                    )
                    probabilities = exact.genotype_posteriors(
                        llks, ploidy, len(haplotypes), prior=prior
                    ).cpu().numpy()
                    llks = llks.cpu().numpy()
                    idx = int(np.argmax(probabilities))
                    alleles = index_as_genotype_alleles_np(idx, ploidy)
                    genotype_prob = probabilities[idx]
                    _, support_probs = exact.alternate_dosage_posteriors(
                        alleles, probabilities
                    )
                    genotype_support_prob = support_probs.sum()
                    if self.require_AFP():
                        freqs, counts, occur = exact.posterior_allele_frequencies(
                            probabilities, ploidy, len(haplotypes)
                        )
                        data.sampledata[VCF.FORMAT_ACP][sample] = np.asarray(counts)
                        data.sampledata[VCF.FORMAT_AFP][sample] = np.asarray(freqs)
                        data.sampledata[VCF.FORMAT_AOP][sample] = np.asarray(occur)
                    if VCF.FORMAT_GL in data.formatfields:
                        data.sampledata[VCF.FORMAT_GL][sample] = np.asarray(
                            natural_log_to_log10(llks)
                        )
                    if VCF.FORMAT_GP in data.formatfields:
                        data.sampledata[VCF.FORMAT_GP][sample] = probabilities
                else:
                    results = exact.posterior_mode(
                        read_dists,
                        ploidy,
                        haplotypes,
                        read_counts=read_counts,
                        prior=prior,
                        return_support_prob=True,
                        return_posterior_frequencies=True,
                        return_posterior_occurrence=True,
                        device=self.device,
                    )
                    alleles, _, genotype_prob, genotype_support_prob = results[0:4]
                    freqs = results[-2]
                    occur = results[-1]
                    data.sampledata[VCF.FORMAT_ACP][sample] = np.asarray(freqs) * ploidy
                    data.sampledata[VCF.FORMAT_AFP][sample] = np.asarray(freqs)
                    data.sampledata[VCF.FORMAT_AOP][sample] = np.asarray(occur)

                data.sampledata[VCF.FORMAT_GT][sample] = np.asarray(alleles)
                data.sampledata[VCF.FORMAT_GQ][sample] = qual_of_prob(genotype_prob)
                data.sampledata[VCF.FORMAT_GPM][sample] = float(genotype_prob)
                data.sampledata[VCF.FORMAT_SPM][sample] = float(genotype_support_prob)
                data.sampledata[VCF.FORMAT_SQ][sample] = qual_of_prob(
                    genotype_support_prob
                )
                data.sampledata[VCF.FORMAT_MCI][sample] = np.nan
                mec = np.sum(
                    minimum_error_correction(read_calls, haplotypes[np.asarray(alleles)])
                )
                mec_denom = np.sum(read_calls >= 0)
                data.sampledata[VCF.FORMAT_MEC][sample] = mec
                data.sampledata[VCF.FORMAT_MECP][sample] = (
                    mec / mec_denom if mec_denom > 0 else np.nan
                )
            except Exception as e:
                message = SAMPLE_ASSEMBLY_ERROR.format(sample=sample)
                raise SampleAssemblyError(message) from e
        return data

    def _finish_sample_stats(self, data, sample, stats, haplotypes):
        """Write one sample's fields from batched exact statistics.

        Mirrors the default (posterior_mode) branch of
        ``call_sample_genotypes`` (reference call_exact.py:161-199).
        """
        alleles = np.asarray(stats["alleles"])
        ploidy = data.sample_ploidy[sample]
        freqs = np.asarray(stats["freqs"])
        data.sampledata[VCF.FORMAT_ACP][sample] = freqs * ploidy
        data.sampledata[VCF.FORMAT_AFP][sample] = freqs
        data.sampledata[VCF.FORMAT_AOP][sample] = np.asarray(stats["occur"])
        data.sampledata[VCF.FORMAT_GT][sample] = alleles
        data.sampledata[VCF.FORMAT_GQ][sample] = qual_of_prob(
            stats["mode_prob"]
        )
        data.sampledata[VCF.FORMAT_GPM][sample] = float(stats["mode_prob"])
        data.sampledata[VCF.FORMAT_SPM][sample] = float(stats["support_prob"])
        data.sampledata[VCF.FORMAT_SQ][sample] = qual_of_prob(
            stats["support_prob"]
        )
        data.sampledata[VCF.FORMAT_MCI][sample] = np.nan
        read_calls = data.read_calls[sample]
        mec = np.sum(
            minimum_error_correction(read_calls, haplotypes[alleles])
        )
        mec_denom = np.sum(read_calls >= 0)
        data.sampledata[VCF.FORMAT_MEC][sample] = mec
        data.sampledata[VCF.FORMAT_MECP][sample] = (
            mec / mec_denom if mec_denom > 0 else np.nan
        )

    def _call_locus_block(self, loci):
        """Exact-call a block of loci with one ``exact_posterior_stats_multi``
        call per ploidy.

        Cross-locus batching for the deterministic exact caller: each
        problem's result is its own exact posterior (panel padding
        occupies a provably zero-mass suffix of the VCF genotype table).
        Each locus's route is set before any device work: NOA/AF0 loci
        are filled as invalid, panels above MAX_BLOCK_PANEL and dense
        GL/GP report fields take the per-locus path, the rest the block
        path.  The reference parallelises this axis with one process per
        locus block (baseclass.py:360-394).
        """
        prepared = []
        with timing.stage("encode_reads"):
            for locus in loci:
                try:
                    data = self._locus_data(locus, self.sample_bams)
                    self.encode_sample_reads(data)
                except Exception as e:
                    raise LocusAssemblyError(_locus_error(locus)) from e
                prepared.append((locus, data))

        dense_fields = any(
            (VCF.FORMAT_GL in d.formatfields) or (VCF.FORMAT_GP in d.formatfields)
            for _, d in prepared
        )

        groups = {}
        setups = {}
        if not dense_fields:
            for idx, (locus, data) in enumerate(prepared):
                haplotypes, prior_frequencies, invalid = self._setup_locus(
                    data
                )
                if invalid:
                    _fill_invalid_sampledata(data)
                    setups[idx] = (haplotypes, "invalid")
                    continue
                if len(haplotypes) > MAX_BLOCK_PANEL:
                    setups[idx] = (haplotypes, "per-locus")
                    continue
                setups[idx] = (haplotypes, "block")
                for sample in data.samples:
                    problem = dict(
                        reads=data.read_dists[sample],
                        counts=data.read_counts[sample],
                        haplotypes=haplotypes,
                    )
                    if data.sample_inbreeding is not None:
                        problem["inbreeding"] = data.sample_inbreeding[sample]
                        problem["frequencies"] = prior_frequencies
                    groups.setdefault(data.sample_ploidy[sample], []).append(
                        (idx, sample, problem)
                    )

        stats = {}
        with timing.stage("device_sampler"):
            for ploidy, items in groups.items():
                results = exact.exact_posterior_stats_multi(
                    [p for _, _, p in items], ploidy, device=self.device
                )
                fallback.note_path("call-exact", "block")
                for (idx, sample, _), r in zip(items, results):
                    stats[(idx, sample)] = r

        results = []
        with timing.stage("summarize_format"):
            for idx, (locus, data) in enumerate(prepared):
                try:
                    haplotypes, mode = setups.get(idx, (None, "per-locus"))
                    if mode == "block":
                        for sample in data.samples:
                            try:
                                self._finish_sample_stats(
                                    data, sample, stats[(idx, sample)],
                                    haplotypes,
                                )
                            except Exception as e:
                                message = SAMPLE_ASSEMBLY_ERROR.format(
                                    sample=sample
                                )
                                raise SampleAssemblyError(message) from e
                    elif mode == "per-locus":
                        self.call_sample_genotypes(data)
                    self.sumarise_vcf_record(data)
                    results.append(data.format_vcf_record())
                except Exception as e:
                    raise LocusAssemblyError(_locus_error(locus)) from e
                timing.tick_loci(1, sample_calls=len(data.samples))
        return results


def _locus_error(locus):
    return LOCUS_ASSEMBLY_ERROR.format(
        name=locus.name, contig=locus.contig, start=locus.start, stop=locus.stop
    )


def _fill_invalid_sampledata(data):
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
