"""Locus model: genomic intervals with known SNVs and haplotype priors.

Covers the surface of reference ``mchap/io/loci.py`` (SNP, Locus,
LocusPrior) on top of the standalone FASTA/VCF readers.
"""

from dataclasses import dataclass

import numpy as np

from mchap_tpu_torch.encoding import character, integer
from mchap_tpu_torch.io.fastalite import FastaFile
from mchap_tpu_torch.io.filter_alleles import apply_allele_filter, parse_allele_filter
from mchap_tpu_torch.io.vcflite import VariantFile

__all__ = ["SNP", "Locus", "LocusPrior"]

_VARIANT_HANDLES = {}


def _variant_handle(path):
    """Shared read-only VariantFile per path (tabix chunks or parsed
    records stay cached across the locus stream)."""
    handle = _VARIANT_HANDLES.get(str(path))
    if handle is None:
        handle = VariantFile(path)
        _VARIANT_HANDLES[str(path)] = handle
    return handle


@dataclass(frozen=True, order=True)
class SNP:
    contig: str
    start: int
    stop: int
    name: str
    alleles: tuple


@dataclass(frozen=True, order=True)
class Locus:
    """A genomic interval with its SNV positions and allowed alleles.

    Reference: io/loci.py:29-172.
    """

    contig: str
    start: int
    stop: int
    name: str
    sequence: str
    variants: tuple

    @property
    def positions(self):
        return [v.start for v in self.variants]

    @property
    def alleles(self):
        return [v.alleles for v in self.variants]

    @property
    def range(self):
        return range(self.start, self.stop)

    def count_alleles(self):
        return [len(tup) for tup in self.alleles]

    def as_dict(self):
        return dict(
            contig=self.contig,
            start=self.start,
            stop=self.stop,
            name=self.name,
            sequence=self.sequence,
            variants=self.variants,
        )

    def set(self, **kwargs):
        data = self.as_dict()
        data.update(kwargs)
        return type(self)(**data)

    def validate_reference_alleles(self):
        """Check VCF reference alleles against the locus sequence."""
        for pos, alleles in zip(self.positions, self.alleles):
            char = alleles[0]
            seq_char = self.sequence[pos - self.start]
            if seq_char != char:
                vcf_pos = pos + 1
                loc = (
                    f"'{self.contig}:{vcf_pos}' in target '{self.name}'"
                    if self.name
                    else f"'{self.contig}:{vcf_pos}'"
                )
                raise ValueError(
                    f"Reference allele of variant '{char}' does not match "
                    f"reference sequence '{seq_char}' at {loc}"
                )

    def set_sequence(self, fasta):
        with FastaFile(fasta) as f:
            sequence = f.fetch(self.contig, self.start, self.stop).upper()
        locus = self.set(sequence=sequence)
        if locus.variants:
            locus.validate_reference_alleles()
        return locus

    def set_variants(self, vcf):
        """Attach SNVs overlapping the locus from a VCF (SNP-only filter,
        duplicate merge); reference io/loci.py:94-135."""
        variants = []
        positions = set()
        # shared per-path handle: header parsed and records indexed once,
        # instead of reopening (and rescanning) the VCF for every locus
        f = _variant_handle(vcf)
        for var in f.fetch(self.contig, self.start, self.stop):
            alleles = (var.ref,) + (var.alts or ())
            if (var.stop - var.start == 1) and all(len(a) == 1 for a in alleles):
                snp = SNP(
                    contig=var.contig,
                    start=var.start,
                    stop=var.stop,
                    name=var.id if var.id else ".",
                    alleles=alleles,
                )
                if snp.start in positions:
                    variants = [
                        _merge_snps(s, snp) if s.start == snp.start else s
                        for s in variants
                    ]
                else:
                    variants.append(snp)
                    positions.add(snp.start)
        locus = self.set(variants=tuple(variants))
        if locus.sequence:
            locus.validate_reference_alleles()
        return locus

    def _template_sequence(self):
        chars = list(self.sequence)
        for pos in self.positions:
            chars[pos - self.start] = "{}"
        return "".join(chars)

    def format_haplotypes(self, array, gap="-"):
        """Integer haplotypes -> full locus sequence strings."""
        variants = integer.as_characters(array, gap=gap, alleles=self.alleles)
        template = self._template_sequence()
        return [template.format(*hap) for hap in variants]

    def format_variants(self, array, gap="-"):
        return integer.as_characters(array, gap=gap, alleles=self.alleles)

    @classmethod
    def from_region_string(cls, string, name=None):
        contig, interval = string.strip().split(":")
        start, stop = interval.strip().split("-")
        return cls(
            contig=contig,
            start=int(start),
            stop=int(stop),
            name=name,
            sequence=None,
            variants=None,
        )


@dataclass(frozen=True, order=True)
class LocusPrior(Locus):
    """Locus with known haplotypes (alts), prior frequencies, ref mask.

    Reference: io/loci.py:175-313.
    """

    alts: tuple = ()
    frequencies: np.ndarray = None
    mask_reference_allele: bool = False

    def set(self, **kwargs):
        raise NotImplementedError

    def set_sequence(self, fasta):
        raise NotImplementedError

    def set_variants(self, vcf):
        raise NotImplementedError

    def encode_haplotypes(self):
        """Known haplotypes as int alleles at the locus SNV positions."""
        strings = (self.sequence,) + self.alts
        chars = np.array([list(string) for string in strings])
        idx = np.array(self.positions, dtype=int) - self.start
        if len(idx) == 0:
            return np.zeros((len(strings), 0), dtype=int)
        return character.as_allelic(chars[:, idx], self.alleles)

    @classmethod
    def from_variant_record(
        cls,
        record,
        use_snvpos=False,
        frequency_tag=None,
        allele_filter=None,
        masked_reference_flag="REFMASKED",
    ):
        """Known-haplotype VCF record -> LocusPrior.

        Reference: io/loci.py:198-313 (REFMASKED flag, prior frequencies
        from an INFO tag, allele filtering that masks rather than drops
        the reference allele).
        """
        ref_length = len(record.ref)
        if record.alts:
            assert all(ref_length == len(alt) for alt in record.alts)
            alts = record.alts
        else:
            alts = ()

        mask_reference_allele = masked_reference_flag in record.info

        keep = None
        if allele_filter is not None:
            filter_args = parse_allele_filter(allele_filter)
            keep = apply_allele_filter(record, *filter_args)
            if not keep[0]:
                mask_reference_allele = True
                keep[0] = True

        n_alleles = len(alts) + 1
        if frequency_tag:
            frequencies = record.info.get(frequency_tag, ())
            if len(frequencies) != n_alleles:
                raise ValueError(
                    f"Field '{frequency_tag}' does not match number of alleles 'n_alleles'."
                )
            frequencies = np.array(frequencies, dtype=float)
        else:
            frequencies = np.ones(n_alleles) / n_alleles
        if mask_reference_allele:
            frequencies[0] = 0

        sequences = (record.ref,) + tuple(alts)

        if keep is not None:
            assert keep[0]
            sequences = tuple(s for s, k in zip(sequences, keep) if k)
            frequencies = frequencies[keep]
            n_alleles = int(keep.sum())

        denom = frequencies.sum()
        if denom > 0:
            frequencies = frequencies / denom
        else:
            frequencies = np.full_like(frequencies, np.nan)

        haplotypes = np.array([list(var) for var in sequences])
        if use_snvpos:
            snvpos = record.info["SNVPOS"]
            if snvpos == (None,):
                snvpos = ()
            positions = np.array(snvpos, int) - 1  # 1-based in VCF
        else:
            positions = np.where((haplotypes != haplotypes[0:1]).any(axis=0))[0]
        snp_alleles = haplotypes[:, positions].T
        snps = []
        for offset, alleles in zip(positions, snp_alleles):
            _, idx = np.unique(alleles, return_index=True)
            idx.sort()
            alleles = tuple(alleles[idx])
            pos = int(offset) + record.start
            snps.append(SNP(record.chrom, pos, pos + 1, ".", alleles=alleles))
        return cls(
            contig=record.chrom,
            start=record.start,
            stop=record.stop,
            name=record.id if record.id else ".",
            sequence=record.ref,
            variants=tuple(snps),
            alts=sequences[1:],
            frequencies=frequencies,
            mask_reference_allele=mask_reference_allele,
        )


def _merge_snps(x, y):
    match = [
        x.contig == y.contig,
        x.name == y.name,
        x.start == y.start,
        x.stop == y.stop,
        x.alleles[0] == y.alleles[0],
    ]
    if not all(match):
        raise ValueError(
            'Cannot merge SNPs "{}: {}:{}" and "{}: {}:{}"'.format(
                x.name, x.contig, x.start, y.name, y.contig, y.start
            )
        )
    alleles = x.alleles + tuple(a for a in y.alleles if a not in x.alleles)
    return SNP(contig=x.contig, start=x.start, stop=x.stop, name=x.name, alleles=alleles)
