"""``mchap call-exact``: exact-enumeration genotype calling.

Reference: mchap/application/call_exact.py; port of
``mchap_tpu/application/call_exact.py``.  Fully deterministic, so its
output is byte-comparable to ``mchap_tpu``'s.  Each locus's route is
chosen from its input before any device work: the block route (every
sample of every such locus of a block through ``exact_stats_sharded``)
or the per-locus route (panels above ``MAX_BLOCK_PANEL``, dense GL/GP
fields).  A failed block launch fails the run: nothing is retried per
locus.
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
from mchap_tpu_torch.application.baseclass import ALT, FILTER, REF, sample_errors
from mchap_tpu_torch.encoding.integer import minimum_error_correction
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.util import qual_of_prob
from mchap_tpu_torch.numerics.combinadics import index_as_genotype_alleles_np
from mchap_tpu_torch.numerics.logprob import natural_log_to_log10
from mchap_tpu_torch.ops import exact
from mchap_tpu_torch.parallel.sharding import run_sharded
from mchap_tpu_torch.utils import fallback
from mchap_tpu_torch.utils.device import resolve_device

# panels above this size take the per-locus route: the padded VCF
# genotype table would grow past C(32+3, 4) rows per problem
MAX_BLOCK_PANEL = 32


def exact_stats_sharded(problems, ploidy, device, devices="auto"):
    """``exact.exact_posterior_stats_multi`` with the block's problems
    spread over ``devices`` (``parallel.sharding.run_sharded``), each
    shard split again where one launch would not fit its device.
    Enumeration draws nothing, so placement changes no result."""
    arrays, use_prior = exact.exact_block_arrays(problems)
    return run_sharded(
        len(problems), arrays,
        lambda sh: exact.exact_block_launch(*sh.arrays, ploidy=ploidy, use_prior=use_prior),
        lambda sh, stats: exact.exact_block_results(stats, sh.arrays[2]),
        devices=devices, device=device,
    )

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
        """Header fields, the NOA/AF0 filters and the locus's route, all
        from the input (reference call_exact.py:52-90).

        Returns None for a filtered locus, its fields filled as invalid;
        otherwise (route, haplotypes, prior_frequencies), the route
        "per-locus" for a panel above MAX_BLOCK_PANEL or dense GL/GP
        report fields, "block" for the rest.
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
            data.columndata[FILTER].append(VCF.NOA.id)
        elif np.any(np.isnan(prior_frequencies)):
            data.columndata[FILTER].append(VCF.AF0.id)
        else:
            dense = (VCF.FORMAT_GL in data.formatfields) or (
                VCF.FORMAT_GP in data.formatfields
            )
            wide = len(haplotypes) > MAX_BLOCK_PANEL
            route = "per-locus" if dense or wide else "block"
            return route, haplotypes, prior_frequencies
        self._fill_invalid_sampledata(data)
        return None

    def _fit_block(self, prepared):
        """Every sample of every "block"-route locus through one
        ``exact_stats_sharded`` call per ploidy.  Each problem's result
        is its own exact posterior (panel padding occupies a provably
        zero-mass suffix of the VCF genotype table).  Returns each
        locus's statistics by sample."""
        groups = {}
        for idx, (data, setup) in enumerate(prepared):
            if setup is None or setup[0] != "block":
                continue
            _, haplotypes, prior_frequencies = setup
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
        for ploidy, items in groups.items():
            results = exact_stats_sharded(
                [p for _, _, p in items], ploidy, device=self.device
            )
            fallback.note_path("call-exact", "block")
            for (idx, sample, _), r in zip(items, results):
                stats.setdefault(idx, {})[sample] = r
        return stats

    def _finish_locus(self, data, setup, stats):
        """Each sample's fields: from the block's statistics, or, on the
        per-locus route, from its own exact call; a filtered locus was
        filled by ``_setup_locus``."""
        if setup is None:
            return
        route, haplotypes, prior_frequencies = setup
        if route == "per-locus":
            self._call_exact_locus(data, haplotypes, prior_frequencies)
            return
        for sample in data.samples:
            with sample_errors(sample):
                self._finish_sample_stats(data, sample, stats[sample], haplotypes)

    def _call_exact_locus(self, data, haplotypes, prior_frequencies):
        """The per-locus route: each sample's exact posterior computed on
        its own; reference call_exact.py:52-199."""
        fallback.note_path("call-exact", "per-locus")
        for sample in data.samples:
            with sample_errors(sample):
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

    def _finish_sample_stats(self, data, sample, stats, haplotypes):
        """Write one sample's fields from batched exact statistics.

        Mirrors the default (posterior_mode) branch of
        ``_call_exact_locus`` (reference call_exact.py:161-199).
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
