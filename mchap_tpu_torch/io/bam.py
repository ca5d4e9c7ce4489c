"""Read extraction and probabilistic encoding from alignment files.

Semantics of reference ``mchap/io/bam.py`` (flag filters, read-group to
sample mapping, mate-pair merge by qname with qual addition for
congruent calls and 'N' for incongruent ones, BAM-vs-locus reference
allele validation) on top of the standalone ``bamlite`` reader.
"""

import numpy as np

from mchap_tpu_torch.encoding.character import as_allelic as _as_allelic
from mchap_tpu_torch.encoding.integer import as_probabilistic as _as_probabilistic
from mchap_tpu_torch.io import util
from mchap_tpu_torch.io.bamlite import AlignmentFile

__all__ = [
    "extract_sample_ids",
    "extract_read_variants",
    "encode_read_alleles",
    "encode_read_distributions",
]

ID_TAGS = {"ID", "SM"}


def extract_sample_ids(bam_paths, id="SM", reference_path=None):
    """Map sample ids -> bam path from @RG headers; io/bam.py:22-51."""
    assert id in ID_TAGS
    data = {}
    for path in bam_paths:
        bam = AlignmentFile(path, reference_filename=reference_path)
        bam_data = {read_group[id]: path for read_group in bam.header["RG"]}
        for sample in bam_data:
            if sample in data:
                raise IOError(
                    'Duplicate sample with id = "{}" in file "{}"'.format(sample, path)
                )
        data.update(bam_data)
    return data


def extract_read_variants(
    locus,
    alignment_file,
    samples=None,
    id="SM",
    min_quality=20,
    skip_duplicates=True,
    skip_qcfail=True,
    skip_supplementary=True,
):
    """Per-sample (chars, quals) matrices at the locus SNV positions.

    Reference: io/bam.py:54-229.  Mate pairs merge by qname: congruent
    calls add quals, incongruent become 'N'.
    """
    assert id in ID_TAGS
    if isinstance(samples, str):
        samples = {samples}

    n_positions = len(locus.positions)
    positions = {pos: i for i, pos in enumerate(locus.positions)}

    data = {}
    sample_keys = {}
    for rg in alignment_file.header["RG"]:
        sample_key = rg[id]
        sample_keys[rg["ID"]] = sample_key
        if samples and sample_key not in samples:
            continue
        data[sample_key] = {}

    for read in alignment_file.fetch(locus.contig, locus.start, locus.stop):
        if read.is_unmapped:
            continue
        if read.mapping_quality < min_quality:
            continue
        if read.is_duplicate and skip_duplicates:
            continue
        if read.is_qcfail and skip_qcfail:
            continue
        if read.is_supplementary and skip_supplementary:
            continue
        sample_key = sample_keys[read.get_tag("RG")]
        if samples and sample_key not in samples:
            continue
        sample_data = data[sample_key]
        if read.qname not in sample_data:
            chars = np.full(n_positions, "-", dtype="U1")
            quals = np.zeros(n_positions, dtype=np.int16)
            sample_data[read.qname] = [chars, quals]
        else:
            chars, quals = sample_data[read.qname]

        for read_pos, ref_pos, ref_char in read.get_aligned_pairs(
            matches_only=True, with_seq=True
        ):
            idx = positions.get(ref_pos)
            if idx is None:
                continue
            # locus (VCF) reference allele must match the alignment ref
            if locus.alleles[idx][0].upper() != ref_char.upper():
                path = alignment_file.filename.decode()
                vcf_pos = ref_pos + 1
                loc = (
                    f"'{locus.contig}:{vcf_pos}' in target '{locus.name}'"
                    if locus.name
                    else f"'{locus.contig}:{vcf_pos}'"
                )
                raise ValueError(
                    f"Reference allele of variant '{locus.alleles[idx][0]}' "
                    f"does not match alignment reference allele "
                    f"'{ref_char}' at position {loc} in '{path}'"
                )
            char = read.seq[read_pos]
            qual = int(read.quals[read_pos])
            if chars[idx] == "-":
                chars[idx] = char
                quals[idx] = qual
            elif chars[idx] == char:
                quals[idx] += qual
            else:
                chars[idx] = "N"

    out = {}
    for sample, reads in data.items():
        tuples = list(reads.values())
        if len(tuples) == 0:
            chars = np.empty((0, n_positions), dtype="U1")
            quals = np.empty((0, n_positions), dtype=np.int16)
        else:
            chars = np.array([t[0] for t in tuples])
            quals = np.array([t[1] for t in tuples])
        out[sample] = (chars, quals)
    return out


def encode_read_alleles(locus, chars):
    """Characters -> integer alleles at the locus; io/bam.py:232-248."""
    return _as_allelic(chars, alleles=locus.alleles)


def encode_read_distributions(locus, calls, quals=None, error_rate=0.0):
    """Integer calls (+quals) -> probabilistic reads; io/bam.py:251-289."""
    n_reads, n_pos = calls.shape
    n_alleles = locus.count_alleles()
    if n_reads == 0:
        max_allele = int(np.max(n_alleles, initial=0))
        return np.empty((n_reads, n_pos, max_allele), dtype=float)
    probs = np.ones(calls.shape, dtype=float) * (1 - error_rate)
    if quals is not None:
        assert calls.shape == quals.shape
        probs = probs * util.prob_of_qual(quals)
    return _as_probabilistic(calls, np.array(n_alleles), probs)
