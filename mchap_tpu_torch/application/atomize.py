"""``mchap atomize``: explode haplotype calls into phased basis-SNV records.

Reference: mchap/application/atomize.py (experimental tool).  Pure
host-side VCF -> VCF transform over the vcflite reader.
"""

import argparse
import sys
import warnings

import numpy as np

from mchap_tpu_torch.application import arguments
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.vcflite import VariantFile


class ExperimentalFeatureWarning(UserWarning):
    pass


def _gt_tuple(cell):
    """'0|0|1|2' or '0/0/./2' -> tuple of ints/None."""
    parts = cell.replace("|", "/").split("/")
    return tuple(None if p == "." else int(p) for p in parts)


def _float_tuple(cell):
    if cell is None or cell == ".":
        return None
    return np.array(
        [np.nan if p == "." else float(p) for p in cell.split(",")]
    )


def get_haplotype_snvs(record):
    """Per-haplotype SNV characters at INFO/SNVPOS; atomize.py:19-28."""
    snv_pos = np.array(record.info["SNVPOS"]) - 1
    n_pos = len(snv_pos)
    n_hap = len(record.alts) + 1
    out = np.zeros((n_hap, n_pos), dtype="U1")
    out[0] = np.array(list(record.ref))[snv_pos]
    for i, alt in enumerate(record.alts):
        out[i + 1] = np.array(list(alt))[snv_pos]
    return out


def format_snv_alleles(haplotype_snvs):
    """(ref chars, alt strings, n_alts) per position; atomize.py:31-43."""
    ref = haplotype_snvs[0]
    _, n_pos = haplotype_snvs.shape
    alts, n_alts = [], []
    for i in range(n_pos):
        _, idx = np.unique(haplotype_snvs[:, i], return_index=True)
        idx.sort()
        assert idx[0] == 0
        idx = idx[1:]
        n_alts.append(len(idx))
        alts.append(",".join(haplotype_snvs[:, i][idx]))
    return ref, np.array(alts), np.array(n_alts)


def get_haplotype_snv_indices(haplotype_snvs):
    """Haplotype chars -> per-position allele indices; atomize.py:46-60."""
    n_hap, n_pos = haplotype_snvs.shape
    out = np.zeros((n_hap, n_pos), dtype=int)
    for i in range(n_pos):
        d = {}
        for h in range(n_hap):
            char = haplotype_snvs[h, i]
            if char not in d:
                d[char] = len(d)
            out[h, i] = d[char]
    return out


def get_sample_snv_ACP(record, haplotype_idxs, sample_ploidy):
    """Per-SNV allele counts from FORMAT/ACP or AFP; atomize.py:63-87."""
    _, n_pos = haplotype_idxs.shape
    n_samples = len(record.samples)
    out = np.zeros((n_pos, n_samples, 4))
    for i, s in enumerate(record.samples):
        ploidy = sample_ploidy[i]
        counts = _float_tuple(record.samples[s].get("ACP"))
        if counts is None:
            freqs = _float_tuple(record.samples[s].get("AFP"))
            if freqs is None:
                out[:, i, :] = np.nan
                continue
            counts = freqs * ploidy
        for h, c in enumerate(counts):
            for p, a in enumerate(haplotype_idxs[h]):
                out[p, i, a] += c
    denom = np.sum(out, axis=-1, keepdims=True)
    denom = np.where(denom == 0.0, np.nan, denom)
    with np.errstate(invalid="ignore"):
        out = out / denom
    return out * np.asarray(sample_ploidy)[None, :, None]


def format_allele_floats(array, alts_number, length="R", precision=3):
    """Comma-joined rounded floats limited per-position; atomize.py:90-119."""
    input_dims = array.ndim
    if input_dims == 2:
        array = array[:, None, :]
    assert length in ("R", "A")
    formatted = []
    for limit, freqs in zip(alts_number, array):
        if length == "R":
            limit += 1
        freqs = freqs[:, 0:limit].round(precision)
        missing = np.isnan(freqs)
        chars = freqs.astype("U16")
        chars = np.char.rstrip(chars, "0")
        chars = np.char.rstrip(chars, ".")
        chars[missing] = "."
        head = chars[:, 0]
        for t in chars[:, 1:].T:
            head = np.char.add(head, ",")
            head = np.char.add(head, t)
        formatted.append(head)
    formatted = np.array(formatted)
    if input_dims == 2:
        formatted = np.squeeze(formatted, 1)
    return formatted


def get_sample_snv_GT(record, haplotype_idxs, sep="|"):
    """Phased per-SNV GT strings + population SNV counts; atomize.py:122-145."""
    n_haps, n_pos = haplotype_idxs.shape
    haplotype_counts = np.zeros(n_haps)
    sample_ploidy = []
    out = []
    for s in record.samples:
        haplotype_gt = _gt_tuple(record.samples[s]["GT"])
        ploidy = len(haplotype_gt)
        sample_ploidy.append(ploidy)
        snv_gts = np.full((ploidy, n_pos), -1, int)
        for i, a in enumerate(haplotype_gt):
            if a is not None:
                haplotype_counts[a] += 1
                snv_gts[i] = haplotype_idxs[a]
        snv_gts = snv_gts.T
        out.append(
            [sep.join([str(a) if a >= 0 else "." for a in call]) for call in snv_gts]
        )
    out = np.array(out)
    snv_counts = np.zeros((n_pos, haplotype_idxs.max() + 1))
    for hap, c in enumerate(haplotype_counts):
        for p, a in enumerate(haplotype_idxs[hap]):
            snv_counts[p, a] += c
    return snv_counts, np.array(sample_ploidy), out.T


def get_sample_snv_PQ(record):
    n_pos = len(record.info["SNVPOS"])
    pq = np.array(
        [d.get("SQ", ".") for d in record.samples.values()]
    ).astype("U16")
    return np.tile(pq, (n_pos, 1))


def get_sample_snv_depth(record):
    p = len(record.info["SNVPOS"])
    null = np.full(p, np.nan)
    out = []
    for s in record.samples:
        dp = _float_tuple(record.samples[s].get("SNVDP"))
        out.append(list(dp) if dp is not None else list(null))
    return np.array(out).T


def format_vcf_snv_block(record):
    """One haplotype record -> per-SNV phased record lines; atomize.py:164-236."""
    if record.info.get("SNVPOS") in ((None,), None):
        return None

    haplotype_snvs = get_haplotype_snvs(record)
    haplotype_idxs = get_haplotype_snv_indices(haplotype_snvs)
    _, n_pos = haplotype_snvs.shape

    ref_column, alts_column, alts_number = format_snv_alleles(haplotype_snvs)
    pos_column = np.array(record.info["SNVPOS"]) - 1 + record.pos
    if record.id:
        id_column = [record.id + "_SNV{}".format(i + 1) for i in range(n_pos)]
    else:
        id_column = ["."] * n_pos

    info_snv_count, sample_ploidy, format_GT = get_sample_snv_GT(
        record, haplotype_idxs
    )
    sample_snv_ACP = get_sample_snv_ACP(record, haplotype_idxs, sample_ploidy)
    format_DS = format_allele_floats(sample_snv_ACP[:, :, 1:], alts_number, length="A")
    format_PQ = get_sample_snv_PQ(record)
    format_GQ = np.full_like(format_PQ, ".")
    sample_depth = get_sample_snv_depth(record)
    format_DP = sample_depth.astype("U16")
    format_DP = np.char.rstrip(format_DP, "0")
    format_DP = np.char.rstrip(format_DP, ".")
    format_DP[np.isnan(sample_depth)] = "."
    sample_data = format_GT
    for field in [format_GQ, format_PQ, format_DP, format_DS]:
        sample_data = np.char.add(sample_data, ":")
        sample_data = np.char.add(sample_data, field)

    info_DP_vals = sample_depth.sum(axis=1)
    info_DP = []
    for v in info_DP_vals:
        if np.isnan(v):
            info_DP.append("DP=.")
        else:
            info_DP.append("DP={}".format(int(v) if v == int(v) else round(v, 3)))
    info_AC = [
        "AC={}".format(c)
        for c in format_allele_floats(info_snv_count[:, 1:], alts_number, length="A")
    ]
    population_snv_ACP = sample_snv_ACP.sum(axis=1)
    info_ACP = [
        "ACP={}".format(c)
        for c in format_allele_floats(population_snv_ACP, alts_number, length="R")
    ]
    info_PS = ["PS={}".format(record.pos)] * n_pos
    info_column = [";".join(tup) for tup in zip(info_AC, info_ACP, info_DP, info_PS)]

    fmt = "GT:GQ:PQ:DP:DS"
    lines = []
    for i in range(n_pos):
        fields = [
            record.chrom,
            str(pos_column[i]),
            id_column[i],
            ref_column[i],
            alts_column[i],
            ".",
            ".",
            info_column[i],
            fmt,
        ] + list(sample_data[i])
        lines.append("\t".join(fields))
    return lines


def atomize_vcf(path, command=None):
    """Stream an atomized VCF to stdout; reference atomize.py:239-285."""
    if command is None:
        command = "atomize {}".format(path)
    vcf = VariantFile(path)
    sys.stdout.write(str(VCF.fileformat("v4.3")) + "\n")
    sys.stdout.write(str(VCF.filedate()) + "\n")
    sys.stdout.write(str(VCF.source()) + "\n")
    sys.stdout.write(str(VCF.commandline(command)) + "\n")
    for line in vcf.header_lines:
        if line.startswith("##contig=<"):
            sys.stdout.write(line + "\n")
    for field in [VCF.INFO_AC, VCF.INFO_ACP, VCF.INFO_DP, VCF.INFO_PS]:
        sys.stdout.write(str(field) + "\n")
    for field in [VCF.FORMAT_GT, VCF.FORMAT_GQ, VCF.FORMAT_PQ, VCF.FORMAT_DP, VCF.FORMAT_DS]:
        sys.stdout.write(str(field) + "\n")
    columns = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT"]
    columns += list(vcf.samples)
    sys.stdout.write("#" + "\t".join(columns) + "\n")
    for record in vcf.fetch():
        lines = format_vcf_snv_block(record)
        if lines is not None:
            sys.stdout.write("\n".join(lines) + "\n")


def main(command):
    warnings.warn("THIS PROGRAM IS EXPERIMENTAL!!!", ExperimentalFeatureWarning)
    parser = argparse.ArgumentParser(
        "Split MCHap haplotype calls into phased blocks of basis SNVs."
    )
    arguments.Parameter(
        "haplotypes",
        dict(
            type=str,
            nargs=1,
            default=[None],
            help="VCF file of haplotype variants to atomize (must contain "
            "INFO/SNVPOS; DP from FORMAT/SNVDP, DS from FORMAT/ACP or "
            "AFP when present).",
        ),
    ).add_to(parser)
    if len(command) < 3:
        parser.print_help()
        sys.exit(1)
    args = parser.parse_args(command[2:])
    atomize_vcf(args.haplotypes[0], command=command)
