"""Read extraction and probabilistic encoding from alignment files.

Semantics of reference ``mchap/io/bam.py`` (flag filters, read-group to
sample mapping, mate-pair merge by qname with qual addition for
congruent calls and 'N' for incongruent ones, BAM-vs-locus reference
allele validation) on top of the standalone ``bamlite`` reader.
"""

import re

import numpy as np

from mchap_tpu_torch.encoding.character import as_allelic as _as_allelic
from mchap_tpu_torch.encoding.integer import as_probabilistic as _as_probabilistic
from mchap_tpu_torch.io import util
from mchap_tpu_torch.io.bamlite import AlignmentFile
from mchap_tpu_torch.utils import timing

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

    The reads of the file are walked once, keeping each read's CIGAR
    match blocks and MD mismatch columns as integers; every (block, SNV)
    pair is then found in one broadcast compare and its base and qual
    gathered from the reads' concatenated sequences and quals.  Adds the
    number of (read, SNV) calls to the counter ``io.snv_calls``.
    """
    assert id in ID_TAGS
    if isinstance(samples, str):
        samples = {samples}

    n_positions = len(locus.positions)
    positions = {pos: i for i, pos in enumerate(locus.positions)}

    data = {}  # sample -> {qname: row}
    sample_keys = {}
    for rg in alignment_file.header["RG"]:
        sample_key = rg[id]
        sample_keys[rg["ID"]] = sample_key
        if samples and sample_key not in samples:
            continue
        data[sample_key] = {}

    reads = _ReadBlocks()
    row_count = []
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
        sample_rows = data[sample_key]
        row = sample_rows.get(read.qname)
        if row is None:
            row = sample_rows[read.qname] = len(row_count)
            row_count.append(0)
        reads.add(read, row, row_count[row])
        row_count[row] += 1

    chars = np.full((len(row_count), n_positions), _DASH, dtype=np.uint32)
    quals = np.zeros((len(row_count), n_positions), dtype=np.int16)
    _read_snvs(locus, alignment_file, positions, reads, chars, quals)
    chars = chars.view("U1")

    out = {}
    for sample, rows in data.items():
        rows = list(rows.values())
        out[sample] = (chars[rows], quals[rows])
    return out


_DASH, _N = ord("-"), ord("N")
_MD_TOKENS = re.compile(r"(\d+)|\^[A-Za-z]*|(.)", re.S)


class _ReadBlocks:
    """The kept reads of one (locus, file) as integers: per CIGAR
    ``M``/``=``/``X`` block its reference start, length, offset into the
    concatenated sequences, offset into the concatenated aligned columns,
    and its read's row and rank among the reads of that row; per MD
    mismatch its column and letter.  ``I``/``S`` advance the read,
    ``D``/``N`` the reference, ``H``/``P`` nothing, as in
    ``AlignedRead.get_aligned_pairs``."""

    def __init__(self):
        self.blocks = []
        self.mismatch_cols, self.mismatch_letters = [], []
        self.seqs, self.quals = [], []
        self.n_bases = self.n_cols = 0

    def add(self, read, row, rank):
        seq = read.seq
        n_bases = len(seq)
        read_i, ref_i, col = 0, read.pos, 0
        for op, ln in read.cigar:
            if op in "M=X":
                self.blocks.append(
                    (ref_i, ln, self.n_bases + read_i, self.n_cols + col, row, rank)
                )
                read_i += ln
                ref_i += ln
                col += ln
            elif op in "IS":
                read_i += ln
            elif op in "DN":
                ref_i += ln
        if read_i > n_bases:
            raise IndexError(f"read '{read.qname}': CIGAR aligns more bases than SEQ holds")
        md = read.tags.get("MD")
        if md is not None:
            md_col = 0
            for run, letter in _MD_TOKENS.findall(md):
                if run:
                    md_col += int(run)
                elif letter:
                    if md_col < col:
                        self.mismatch_cols.append(self.n_cols + md_col)
                        self.mismatch_letters.append(letter)
                    md_col += 1
            if md_col < col:
                raise IndexError(f"read '{read.qname}': MD covers fewer columns than its CIGAR")
        quals = read.quals
        if len(quals) != n_bases:
            if len(quals) < n_bases:
                raise IndexError(f"read '{read.qname}': QUAL is shorter than SEQ")
            quals = quals[:n_bases]
        self.seqs.append(seq)
        self.quals.append(quals)
        self.n_bases += n_bases
        self.n_cols += col


def _read_snvs(locus, alignment_file, positions, reads, chars, quals):
    """Scatter every (read, SNV) call of ``reads`` into the rows of
    ``chars`` (code points) and ``quals``, merging mates in fetch order."""
    snv_pos = np.fromiter(positions, np.int64, len(positions))
    snv_idx = np.fromiter(positions.values(), np.int64, len(positions))
    order = np.argsort(snv_pos, kind="stable")
    snv_pos, snv_idx = snv_pos[order], snv_idx[order]

    blocks = np.array(reads.blocks, np.int64).reshape(-1, 6)
    offset = snv_pos[None, :] - blocks[:, :1]
    # (block, SNV) pairs: by read in fetch order, then by read position
    block, snv = np.nonzero((offset >= 0) & (offset < blocks[:, 1:2]))
    timing.count("io.snv_calls", len(block))
    if len(block) == 0:
        return
    offset = offset[block, snv]
    seq_at, col_at, row, rank = blocks[block, 2:].T
    seq_at = seq_at + offset
    col_at = col_at + offset

    bases = np.array(["".join(reads.seqs)]).view(np.uint32)[seq_at]
    base_quals = np.concatenate(reads.quals)[seq_at]

    # the alignment's reference base: the MD letter (lowercase) at a
    # mismatch, else the read's own base (also without an MD tag)
    ref_chars = bases
    if reads.mismatch_cols:
        mismatch_cols = np.array(reads.mismatch_cols, np.int64)
        at = np.searchsorted(mismatch_cols, col_at).clip(max=len(mismatch_cols) - 1)
        letters = np.array(["".join(reads.mismatch_letters)]).view(np.uint32)
        ref_chars = np.where(mismatch_cols[at] == col_at, _ascii_lower(letters)[at], bases)
    alleles = locus.alleles
    ref_alleles = [alleles[i][0].upper() for i in snv_idx.tolist()]
    ref_alleles = np.array([ord(a) if len(a) == 1 else -1 for a in ref_alleles])
    bad = np.flatnonzero(_ascii_upper(ref_chars) != ref_alleles[snv])
    if len(bad):
        k = bad[0]
        idx = int(snv_idx[snv[k]])
        path = alignment_file.filename.decode()
        vcf_pos = int(snv_pos[snv[k]]) + 1
        loc = (
            f"'{locus.contig}:{vcf_pos}' in target '{locus.name}'"
            if locus.name
            else f"'{locus.contig}:{vcf_pos}'"
        )
        raise ValueError(
            f"Reference allele of variant '{alleles[idx][0]}' "
            f"does not match alignment reference allele "
            f"'{chr(ref_chars[k])}' at position {loc} in '{path}'"
        )

    # the k-th read of a qname meets what the reads before it left: '-'
    # takes the base and qual, the same base adds its qual, another is 'N'
    cell = row * chars.shape[1] + snv_idx[snv]
    chars, quals = chars.reshape(-1), quals.reshape(-1)
    for k in range(int(rank.max()) + 1):
        at = rank == k
        c, b, q = cell[at], bases[at], base_quals[at]
        held = chars[c]
        empty, same = held == _DASH, held == b
        chars[c] = np.where(empty, b, np.where(same, held, _N))
        quals[c] = np.where(empty, q, quals[c] + np.where(same, q, 0))


def _ascii_upper(codes):
    return np.where((codes >= 97) & (codes <= 122), codes - 32, codes)


def _ascii_lower(codes):
    return np.where((codes >= 65) & (codes <= 90), codes + 32, codes)


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
