"""``mchap find-snvs``: basis-SNV discovery from read pileups.

Reference: mchap/application/find_snvs.py (pysam pileup there; here the
per-position allele depths come from the standalone BAM reader's aligned
pairs).  Output format (REFMASKED/AD/ADMF INFO, GT='.' + AD FORMAT,
allele ordering: reference first then descending mean frequency with
ties in reverse allele order) matches the reference's golden outputs.
"""

import argparse
import sys

import numpy as np

from mchap_tpu_torch.application import arguments
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.bamlite import AlignmentFile
from mchap_tpu_torch.io.fastalite import FastaFile
from mchap_tpu_torch.io.vcf import vcfstr

_BASE_INDEX = {"A": 0, "a": 0, "C": 1, "c": 1, "G": 2, "g": 2, "T": 3, "t": 3}


def bases_to_indices(alleles):
    """Base characters -> indices 0-3 (A,C,G,T), -1 otherwise."""
    return np.array([_BASE_INDEX.get(str(a), -1) for a in alleles], dtype=np.int8)


def bam_samples(bam_paths, reference_path, tag="SM"):
    """One sample per bam, validated; reference find_snvs.py:218-233."""
    out = []
    for path in bam_paths:
        bam = AlignmentFile(path, reference_filename=reference_path)
        read_groups = bam.header["RG"]
        sample_id = read_groups[0][tag]
        for rg in read_groups:
            if rg[tag] != sample_id:
                raise ValueError(
                    "Expected one sample per bam but found {} and {} in {}".format(
                        sample_id, rg[tag], path
                    )
                )
        out.append(sample_id)
    return np.array(out)


def bam_region_depths(
    bam_paths,
    reference_path,
    contig,
    start,
    stop,
    dtype=np.int64,
    min_base_quality=13,
    skip_duplicates=True,
    skip_qcfail=True,
    skip_supplementary=True,
    min_quality=0,
):
    """Per-position allele depth [n_pos, n_samples, 4] over a region.

    Equivalent of the reference's pysam pileup loop
    (find_snvs.py:236-265); pysam's default stepper excludes unmapped/
    secondary/qcfail/duplicate reads and bases below quality 13.
    """
    n_pos = stop - start
    depths = np.zeros((n_pos, len(bam_paths), 4), dtype=dtype)
    for j, path in enumerate(bam_paths):
        bam = AlignmentFile(path, reference_filename=reference_path)
        for read in bam.fetch(contig, start, stop):
            if read.is_unmapped:
                continue
            if read.flag & 0x100:  # secondary
                continue
            if read.is_qcfail and skip_qcfail:
                continue
            if read.is_duplicate and skip_duplicates:
                continue
            if read.is_supplementary and skip_supplementary:
                continue
            if read.mapping_quality < min_quality:
                continue
            for read_pos, ref_pos in read.get_aligned_pairs(matches_only=True):
                if ref_pos < start or ref_pos >= stop:
                    continue
                if read.quals[read_pos] < min_base_quality:
                    continue
                a = _BASE_INDEX.get(read.seq[read_pos], -1)
                if a >= 0:
                    depths[ref_pos - start, j, a] += 1
    return depths


def write_vcf_header(command, reference_path, info_fields=None, format_fields=None,
                     samples=None):
    """Header for the basis VCF; reference find_snvs.py:268-302."""
    components = [
        str(VCF.fileformat("v4.3")),
        str(VCF.filedate()),
        str(VCF.source()),
        str(VCF.commandline(command)),
    ]
    with FastaFile(reference_path) as reference:
        components.append(str(VCF.reference(reference_path)))
        components.append(
            "\n".join(
                str(VCF.ContigHeader(s, i))
                for s, i in zip(reference.references, reference.lengths)
            )
        )
    if info_fields is not None:
        components.append("\n".join(str(f) for f in info_fields))
    if format_fields is not None:
        components.append("\n".join(str(f) for f in format_fields))
    columns = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
    if samples is not None:
        columns += ["FORMAT"] + list(samples)
    components.append("#" + "\t".join(columns))
    sys.stdout.write("\n".join(components) + "\n")


def _vcf_sort_alleles(frequencies, reference_index):
    """Allele order: reference first, then descending mean frequency with
    ties in reverse allele order (matching the reference's reversed
    stable argsort, find_snvs.py:319-326)."""
    n_variants, n_alleles = frequencies.shape
    order = np.argsort(frequencies, axis=-1, kind="stable")[:, ::-1].astype(int)
    reference_index = reference_index[:, None].astype(int)
    not_ref = order != reference_index
    alt_order = order.ravel()[not_ref.ravel()].reshape(n_variants, n_alleles - 1)
    return np.hstack([reference_index, alt_order])


def _order_as_vcf_alleles(order, keep):
    chars = np.array(["A", "C", "G", "T"])
    chars = chars[order]
    chars = np.where(keep, chars, "")
    ref = chars[:, 0]
    alts = np.array(
        [",".join(c for c in row if c) for row in chars[:, 1:]]
    )
    return ref, alts


def format_allele_counts(counts, keep, sep=","):
    """Per-sample kept-allele depth strings; find_snvs.py:341-353."""
    n_variant, n_sample, n_allele = counts.shape
    if keep.ndim == 2:
        keep = keep[:, None, :]
    keep = np.broadcast_to(keep, (n_variant, n_sample, n_allele))
    out = np.empty((n_variant, n_sample), dtype=object)
    for i in range(n_variant):
        for j in range(n_sample):
            out[i, j] = sep.join(
                str(counts[i, j, k]) for k in range(n_allele) if keep[i, j, k]
            )
    return out


def write_vcf_block(
    contig, start, stop, reference_path, bam_paths,
    maf, mad, ind_maf, ind_mad, min_ind,
    mapping_quality, skip_duplicates, skip_qcfail, skip_supplementary,
):
    """Threshold, sort, format, and emit one BED interval's SNVs.

    Reference: find_snvs.py:403-561.
    """
    assert start < stop
    variant_position = np.arange(start, stop)
    variant_contig = np.full(len(variant_position), contig)
    with FastaFile(reference_path) as reference:
        variant_reference = np.array(list(reference.fetch(contig, start, stop).upper()))
    variant_reference_index = bases_to_indices(variant_reference)
    allele_depth = bam_region_depths(
        bam_paths,
        reference_path,
        contig,
        start,
        stop,
        min_quality=mapping_quality,
        skip_duplicates=skip_duplicates,
        skip_qcfail=skip_qcfail,
        skip_supplementary=skip_supplementary,
    )
    idx = variant_reference_index >= 0
    if np.any(~idx):
        variant_position = variant_position[idx]
        variant_contig = variant_contig[idx]
        variant_reference = variant_reference[idx]
        variant_reference_index = variant_reference_index[idx]
        allele_depth = allele_depth[idx]
    if len(variant_position) < 1:
        return

    with np.errstate(divide="ignore", invalid="ignore"):
        allele_freq = allele_depth / allele_depth.sum(axis=-1, keepdims=True)
    keep = ((allele_freq >= ind_maf) & (allele_depth >= ind_mad)).sum(axis=1) >= min_ind
    if maf > 0.0:
        import warnings as _warnings

        with _warnings.catch_warnings(), np.errstate(invalid="ignore"):
            _warnings.simplefilter("ignore", RuntimeWarning)
            keep &= np.nan_to_num(np.nanmean(allele_freq, axis=1)) >= maf
    if mad > 0:
        keep &= np.sum(allele_depth, axis=1) >= mad
    idx = keep.sum(axis=-1) > 1
    if idx.sum() == 0:
        return
    variant_contig = variant_contig[idx]
    variant_position = variant_position[idx]
    variant_reference = variant_reference[idx]
    variant_reference_index = variant_reference_index[idx]
    allele_depth = allele_depth[idx]
    allele_freq = allele_freq[idx]
    keep = keep[idx]

    allele_freq = np.where(keep[:, None, :], allele_freq, 0.0)
    with np.errstate(invalid="ignore"):
        depth_mean_freq = np.nanmean(allele_freq, axis=1)

    order = _vcf_sort_alleles(depth_mean_freq, variant_reference_index)
    row = np.arange(len(order))[:, None]
    allele_depth = allele_depth[row[:, None], np.arange(allele_depth.shape[1])[None, :, None], order[:, None, :]]
    depth_mean_freq = depth_mean_freq[row, order]
    keep = keep[row, order]

    reference_masked = ~keep[:, 0]
    keep[:, 0] = True

    reference_allele, alternate_alleles = _order_as_vcf_alleles(order, keep)
    assert np.all(reference_allele == variant_reference)

    pop_depth = allele_depth.sum(axis=1)
    info = [
        "AD=" + vcfstr(d[k]) + ";ADMF=" + vcfstr(f[k])
        for d, f, k in zip(pop_depth, depth_mean_freq.round(3), keep)
    ]
    for i, masked in enumerate(reference_masked):
        if masked:
            info[i] = "REFMASKED;" + info[i]

    ad_strings = format_allele_counts(allele_depth, keep)
    lines = []
    for i in range(len(variant_contig)):
        fields = [
            str(variant_contig[i]),
            str(variant_position[i] + 1),
            ".",
            str(reference_allele[i]),
            alternate_alleles[i],
            ".",
            ".",
            info[i],
            "GT:AD",
        ] + [".:" + ad_strings[i, j] for j in range(ad_strings.shape[1])]
        lines.append("\t".join(fields))
    sys.stdout.write("\n".join(lines) + "\n")


def main(command):
    parser = argparse.ArgumentParser("WARNING this tool is experimental")
    args_list = [
        arguments.basis_targets,
        arguments.reference,
        arguments.bam,
        arguments.find_snvs_maf,
        arguments.find_snvs_mad,
        arguments.find_snvs_ind_maf,
        arguments.find_snvs_ind_mad,
        arguments.find_snvs_min_ind,
        arguments.read_group_field,
        arguments.mapping_quality,
        arguments.skip_duplicates,
        arguments.skip_qcfail,
        arguments.skip_supplementary,
    ]
    for arg in args_list:
        arg.add_to(parser)
    if len(command) < 3:
        parser.print_help()
        sys.exit(1)
    args = parser.parse_args(command[2:])
    bed_path = args.targets[0]
    intervals = []
    from mchap_tpu_torch.io.bed import read_bed4

    for locus in read_bed4(bed_path):
        intervals.append((locus.contig, locus.start, locus.stop))
    reference_path = args.reference[0]
    samples, sample_bams = arguments.parse_sample_bam_paths(
        args.bam, None, args.read_group_field[0], reference_path=reference_path
    )
    samples = np.array(samples)
    bam_paths = np.array([sample_bams[s][0][1] for s in samples])
    samples_found = bam_samples(
        bam_paths, reference_path, tag=args.read_group_field[0]
    ).astype("U")
    mismatch = samples_found != samples
    if np.any(mismatch):
        raise IOError(
            "Samples ({}) did not match bam files ({})".format(
                samples[mismatch], bam_paths[mismatch]
            )
        )
    info_fields = [VCF.INFO_REFMASKED, VCF.INFO_AD, VCF.INFO_ADMF]
    format_fields = [VCF.FORMAT_GT, VCF.FORMAT_AD]
    write_vcf_header(
        command,
        reference_path,
        samples=samples,
        info_fields=info_fields,
        format_fields=format_fields,
    )
    for contig, start, stop in intervals:
        write_vcf_block(
            contig,
            start,
            stop,
            reference_path,
            bam_paths,
            maf=args.maf[0],
            mad=args.mad[0],
            ind_maf=args.ind_maf[0],
            ind_mad=args.ind_mad[0],
            min_ind=args.min_ind[0],
            mapping_quality=args.mapping_quality[0],
            skip_duplicates=args.skip_duplicates,
            skip_qcfail=args.skip_qcfail,
            skip_supplementary=args.skip_supplementary,
        )
