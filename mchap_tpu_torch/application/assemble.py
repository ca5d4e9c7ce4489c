"""``mchap assemble``: de novo micro-haplotype assembly.

Reference: mchap/application/assemble.py; port of
``mchap_tpu/application/assemble.py``.  Every (locus, sample) problem of
a block runs through one call of the de novo sampler: K1, or the torch
de novo sampler where K1 cannot run the block (``models/assemble.py``).
A failed block fails the run: nothing falls back to another path.
"""

import argparse
import sys
from dataclasses import dataclass

import numpy as np

from mchap_tpu_torch import mset
from mchap_tpu_torch.application import baseclass
from mchap_tpu_torch.utils import timing
from mchap_tpu_torch.utils.device import resolve_device
from mchap_tpu_torch.application.arguments import (
    ASSEMBLE_MCMC_PARSER_ARGUMENTS,
    collect_assemble_mcmc_program_arguments,
)
from mchap_tpu_torch.application.baseclass import ALT, FILTER, REF, sample_errors
from mchap_tpu_torch.encoding.integer import minimum_error_correction
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.bed import read_bed4
from mchap_tpu_torch.io.fastalite import FastaFile
from mchap_tpu_torch.io.loci import Locus
from mchap_tpu_torch.io.util import qual_of_prob
from mchap_tpu_torch.models.assemble import (
    call_posterior_haplotypes,
    fit_denovo_multi,
    zero_variant_trace,
)
from mchap_tpu_torch.numerics.combinadics import (
    count_unique_genotypes,
    genotype_alleles_as_index,
)
from mchap_tpu_torch.numerics.logprob import natural_log_to_log10
from mchap_tpu_torch.ops import exact


@dataclass
class program(baseclass.program):
    bed: str = ""
    region: str = None
    region_id: str = None
    haplotype_posterior_threshold: float = 0.2
    mcmc_chains: int = 1
    mcmc_steps: int = 2000
    mcmc_burn: int = 1000
    mcmc_alpha: float = 1.0
    mcmc_beta: float = 3.0
    mcmc_fix_homozygous: float = 0.999
    mcmc_recombination_step_probability: float = 0.5
    mcmc_partial_dosage_step_probability: float = 0.5
    mcmc_dosage_step_probability: float = 1.0
    mcmc_incongruence_threshold: float = 0.60
    mcmc_llk_cache_threshold: int = 100
    sample_mcmc_temperatures: dict = None

    @classmethod
    def cli(cls, command):
        parser = argparse.ArgumentParser("MCMC haplotype assembly")
        for arg in ASSEMBLE_MCMC_PARSER_ARGUMENTS:
            arg.add_to(parser)
        if len(command) < 3:
            parser.print_help()
            sys.exit(1)
        args = parser.parse_args(command[2:])
        arguments = collect_assemble_mcmc_program_arguments(args)
        arguments["device"] = resolve_device(arguments["device"])
        return cls(cli_command=command, **arguments)

    def loci(self):
        if (self.bed is None) and (self.region is None):
            raise ValueError("No region or targets bedfile is specified.")
        if self.bed is not None:
            for b in read_bed4(self.bed):
                yield b.set_sequence(self.ref).set_variants(self.vcf)
        else:
            locus = Locus.from_region_string(self.region, self.region_id)
            yield locus.set_sequence(self.ref).set_variants(self.vcf)

    def header_contigs(self):
        with FastaFile(self.ref) as fasta:
            return [
                VCF.ContigHeader(c, length)
                for c, length in zip(fasta.references, fasta.lengths)
            ]

    def _fit_block(self, prepared):
        """Every (locus, sample) assembly problem of the block through one
        ``fit_denovo_multi`` call per (ploidy, tempering ladder) group.
        A locus without SNVs takes the constant zero-variant trace, with
        no launch.  Returns each locus's unburnt traces by sample."""
        traces = {}
        groups = {}
        for idx, (data, _) in enumerate(prepared):
            n_alleles = data.locus.count_alleles()
            if len(n_alleles) == 0:
                traces[idx] = {
                    sample: zero_variant_trace(
                        self.mcmc_chains, self.mcmc_steps, data.sample_ploidy[sample]
                    )
                    for sample in data.samples
                }
                continue
            for sample in data.samples:
                problem = dict(
                    reads=data.read_dists[sample],
                    counts=data.read_counts[sample],
                    n_alleles=n_alleles,
                )
                if data.sample_inbreeding is not None:
                    problem["inbreeding"] = data.sample_inbreeding[sample]
                key = (
                    data.sample_ploidy[sample],
                    tuple(self.sample_mcmc_temperatures[sample]),
                )
                groups.setdefault(key, []).append((idx, sample, problem))

        for (ploidy, ladder), items in groups.items():
            fitted = fit_denovo_multi(
                [p for _, _, p in items],
                ploidy,
                steps=self.mcmc_steps,
                chains=self.mcmc_chains,
                alpha=self.mcmc_alpha,
                beta=self.mcmc_beta,
                fix_homozygous=self.mcmc_fix_homozygous,
                recombination_step_probability=self.mcmc_recombination_step_probability,
                partial_dosage_step_probability=self.mcmc_partial_dosage_step_probability,
                dosage_step_probability=self.mcmc_dosage_step_probability,
                temperatures=ladder,
                random_seed=self.random_seed,
                burn=self.mcmc_burn,
                device=self.device,
            )
            timing.count(
                "sampler.steps",
                len(items) * self.mcmc_chains * self.mcmc_steps
            )
            for (idx, sample, _), t in zip(items, fitted):
                traces.setdefault(idx, {})[sample] = t
        return traces

    def _finish_locus(self, data, setup, traces):
        """Per-sample posteriors + population allele pooling from the
        locus's traces; reference application/assemble.py:95-252."""
        sample_modes = {}
        sample_posteriors = {}
        for sample in data.samples:
            with sample_errors(sample):
                read_calls = data.read_calls[sample]
                trace = traces[sample].burn(self.mcmc_burn)
                posterior = trace.posterior()
                sample_posteriors[sample] = posterior

                genotype_support = posterior.mode_genotype_support()
                genotype_support_prob = genotype_support.probabilities.sum()
                data.sampledata[VCF.FORMAT_SPM][sample] = genotype_support_prob
                data.sampledata[VCF.FORMAT_SQ][sample] = qual_of_prob(
                    genotype_support_prob
                )
                genotype, genotype_prob = genotype_support.mode_genotype()
                sample_modes[sample] = genotype
                data.sampledata[VCF.FORMAT_GQ][sample] = qual_of_prob(genotype_prob)
                data.sampledata[VCF.FORMAT_GPM][sample] = genotype_prob

                mec = np.sum(minimum_error_correction(read_calls, genotype))
                mec_denom = np.sum(read_calls >= 0)
                data.sampledata[VCF.FORMAT_MEC][sample] = mec
                data.sampledata[VCF.FORMAT_MECP][sample] = (
                    mec / mec_denom if mec_denom > 0 else np.nan
                )
                data.sampledata[VCF.FORMAT_MCI][sample] = trace.replicate_incongruence(
                    threshold=self.mcmc_incongruence_threshold
                )

        haplotypes, ref_called = call_posterior_haplotypes(
            list(sample_posteriors.values()),
            threshold=self.haplotype_posterior_threshold,
        )
        haplotype_labels = {h.tobytes(): i for i, h in enumerate(haplotypes)}
        data.infodata[VCF.INFO_REFMASKED] = not ref_called
        if not ref_called:
            haplotype_labels.pop(haplotypes[0].tobytes())
            if len(haplotypes) == 1:
                data.columndata[FILTER].append(VCF.NOA.id)

        if len(haplotypes) > 1:
            alts = data.locus.format_haplotypes(haplotypes[1:])
        else:
            alts = []
        data.columndata[REF] = data.locus.sequence
        data.columndata[ALT] = alts

        for sample in data.samples:
            with sample_errors(sample):
                alleles = _genotype_as_alleles(sample_modes[sample], haplotype_labels)
                data.sampledata[VCF.FORMAT_GT][sample] = alleles

                if self.require_AFP():
                    frequencies = np.zeros(len(haplotypes))
                    occurrences = np.zeros(len(haplotypes))
                    haps, freqs, occur = sample_posteriors[sample].allele_frequencies()
                    idx = mset.categorize(haplotypes, haps)
                    frequencies[idx >= 0] = freqs[idx[idx >= 0]]
                    occurrences[idx >= 0] = occur[idx[idx >= 0]]
                    data.sampledata[VCF.FORMAT_AFP][sample] = frequencies
                    data.sampledata[VCF.FORMAT_AOP][sample] = occurrences
                    data.sampledata[VCF.FORMAT_ACP][sample] = (
                        frequencies * data.sample_ploidy[sample]
                    )
                if VCF.FORMAT_GP in data.formatfields:
                    data.sampledata[VCF.FORMAT_GP][sample] = (
                        _genotype_posterior_as_array(
                            sample_posteriors[sample], haplotype_labels
                        )
                    )
                if VCF.FORMAT_GL in data.formatfields:
                    read_dists = data.read_dists[sample]
                    read_counts = data.read_counts[sample]
                    llks = exact.genotype_likelihoods(
                        read_dists,
                        data.sample_ploidy[sample],
                        haplotypes,
                        read_counts,
                        device=self.device,
                    ).cpu().numpy()
                    data.sampledata[VCF.FORMAT_GL][sample] = np.asarray(
                        natural_log_to_log10(llks)
                    )


def _genotype_as_alleles(genotype, labels):
    """Haplotype-matrix genotype -> sorted allele indices (-1 unknown).

    Reference: application/assemble.py:255-273.
    """
    alleles = np.sort([labels.get(h.tobytes(), -1) for h in genotype])
    return np.append(alleles[alleles >= 0], alleles[alleles < 0])


def _genotype_posterior_as_array(posterior, labels):
    """Posterior over labeled genotypes as a dense G-length array.

    Reference: application/assemble.py:276-305.
    """
    n_alleles = len(labels)
    _, ploidy, _ = posterior.genotypes.shape
    u_gens = count_unique_genotypes(n_alleles, ploidy)
    probabilities = np.zeros(u_gens, float)
    for haps, prob in zip(posterior.genotypes, posterior.probabilities):
        alleles = np.sort([labels.get(h.tobytes(), -1) for h in haps])
        if alleles[0] < 0:
            continue
        idx = int(genotype_alleles_as_index(alleles))
        probabilities[idx] = prob
    return probabilities
