"""Plain reference of the host read layer: SAM records to encoded reads.

Works again, from the files the benchmark wrote, what ``mchap assemble``
and ``mchap call`` derive from them (MCHap v0.11.1 semantics): the loci
and their SNVs, each sample's reads at a locus with mate pairs merged by
name, the allele calls, the probabilistic encoding at the base error
rate (base qualities ignored, MCHap's default), the de-duplicated reads
with their counts, and the per-sample read statistics that each VCF
record reports (``DP``, ``RCOUNT``, ``RCALLS``).  Imports only numpy and
the standard library: nothing of the program.
"""

import bisect
import re
from dataclasses import dataclass

import numpy as np

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_SKIP_FLAGS = 0x4 | 0x200 | 0x400 | 0x800  # unmapped, qcfail, duplicate, supplementary


@dataclass
class Locus:
    name: str
    contig: str
    start: int  # 0-based, half open
    stop: int
    positions: np.ndarray  # 0-based reference positions of the SNVs
    alleles: list  # per SNV, the allele characters, reference first


@dataclass
class SampleReads:
    calls: np.ndarray  # int [reads, snvs], -1 where no allele is called
    depth: int  # DP: mean depth over the SNVs, rounded
    count: int  # RCOUNT
    n_calls: int  # RCALLS
    dists: np.ndarray  # f64 [distinct reads, snvs, max alleles], nan where no call
    counts: np.ndarray  # f64 [distinct reads]


def read_sam(path):
    """A SAM file's alignments as (read group, name, contig, 0-based
    start, CIGAR, sequence), without those that MCHap skips by flag or
    by a mapping quality under 20."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            flag, mapq = int(fields[1]), int(fields[4])
            if flag & _SKIP_FLAGS or mapq < 20:
                continue
            rg = next(t[5:] for t in fields[11:] if t.startswith("RG:Z:"))
            out.append((rg, fields[0], fields[2], int(fields[3]) - 1, fields[5], fields[9]))
    return out


def _aligned_bases(start, cigar, seq):
    """{reference position: base} over the read's aligned matches."""
    ops = _CIGAR.findall(cigar)
    if len(ops) == 1 and ops[0][1] in "M=X":
        return None  # ungapped: base at p is seq[p - start]
    out, ref, query = {}, start, 0
    for n, op in ops:
        n = int(n)
        if op in "M=X":
            for k in range(n):
                out[ref + k] = seq[query + k]
            ref += n
            query += n
        elif op in "IS":
            query += n
        elif op in "DN":
            ref += n
    return out


def index_alignments(alignments):
    """Alignments by contig, sorted by start, with their reference spans,
    for ``sample_reads``."""
    out = {}
    for rg, name, contig, start, cigar, seq in alignments:
        span = sum(int(n) for n, op in _CIGAR.findall(cigar) if op in "MDN=X")
        out.setdefault(contig, []).append((start, start + span, name, cigar, seq))
    for rows in out.values():
        rows.sort(key=lambda row: row[0])
    return {c: ([r[0] for r in rows], max(r[1] - r[0] for r in rows), rows)
            for c, rows in out.items()}


def sample_reads(indexed, locus, error_rate):
    """One sample's reads at ``locus`` (from ``index_alignments``),
    encoded as MCHap encodes them."""
    n_pos = len(locus.positions)
    merged = {}
    starts, longest, rows = indexed.get(locus.contig, ([], 0, []))
    lo = bisect.bisect_left(starts, locus.start - longest)
    hi = bisect.bisect_left(starts, locus.stop)
    for start, end, name, cigar, seq in rows[lo:hi]:
        if end <= locus.start:
            continue
        bases = _aligned_bases(start, cigar, seq)
        chars = merged.setdefault(name, ["-"] * n_pos)
        for j, p in enumerate(locus.positions):
            if bases is None:
                base = seq[p - start] if start <= p < start + len(seq) else None
            else:
                base = bases.get(p)
            if base is None:
                continue
            if chars[j] == "-":
                chars[j] = base
            elif chars[j] != base:
                chars[j] = "N"  # incongruent mates
    per_read = list(merged.values())
    calls = np.full((len(per_read), n_pos), -1, np.int64)
    for i, chars in enumerate(per_read):
        for j, c in enumerate(chars):
            if c in locus.alleles[j]:
                calls[i, j] = locus.alleles[j].index(c)
    depth = np.array([sum(r[j] != "-" for r in per_read) for j in range(n_pos)])
    n_alleles = np.array([len(a) for a in locus.alleles])
    max_a = int(n_alleles.max(initial=1))
    onehot = calls[..., None] == np.arange(max_a)
    dists = np.where(onehot, 1.0 - error_rate, error_rate / 3.0)
    dists = np.where(calls[..., None] < 0, np.nan, dists)
    dists = np.where(np.arange(max_a) >= n_alleles[:, None], 0.0, dists)
    if len(per_read):
        keys = np.where(np.isnan(dists), -1.0, dists).reshape(len(per_read), -1)
        _, first, counts = np.unique(keys, axis=0, return_index=True, return_counts=True)
        order = np.argsort(first)
        uniq, counts = dists[first[order]], counts[order].astype(float)
    else:
        uniq, counts = dists, np.zeros(0)
    return SampleReads(
        calls=calls,
        depth=int(np.round(depth.mean())) if n_pos else -1,
        count=len(per_read),
        n_calls=int((calls >= 0).sum()),
        dists=uniq,
        counts=counts,
    )


def bed_loci(bed_path, variants_path):
    """``mchap assemble``'s loci: BED intervals with the VCF's SNVs in them."""
    snvs = []
    with open(variants_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            chrom, pos, _, ref, alt = line.split("\t")[:5]
            snvs.append((chrom, int(pos) - 1, [ref] + alt.split(",")))
    loci = []
    with open(bed_path) as f:
        for line in f:
            contig, start, stop, name = line.split()[:4]
            start, stop = int(start), int(stop)
            inside = [s for s in snvs if s[0] == contig and start <= s[1] < stop]
            loci.append(Locus(name, contig, start, stop,
                              np.array([s[1] for s in inside], np.int64),
                              [s[2] for s in inside]))
    return loci


def panel_loci(panel_path, frequency_tag="AFP"):
    """``mchap call``'s loci from a haplotype VCF: per record the locus,
    its haplotypes as allele vectors over the SNVs where they differ
    (alleles in order of first appearance, reference first), and the
    record's ``frequency_tag`` values (None where absent)."""
    out = []
    with open(panel_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            seqs = [fields[3]] + ([] if fields[4] == "." else fields[4].split(","))
            info = dict(kv.split("=", 1) for kv in fields[7].split(";") if "=" in kv)
            start = int(fields[1]) - 1
            chars = np.array([list(s) for s in seqs])
            offsets = np.flatnonzero((chars != chars[:1]).any(axis=0))
            alleles = [list(dict.fromkeys(chars[:, o])) for o in offsets]
            haps = np.array([[alleles[j].index(c) for j, c in enumerate(chars[h, offsets])]
                             for h in range(len(seqs))], np.int64).reshape(len(seqs), len(offsets))
            freqs = info.get(frequency_tag)
            out.append(dict(
                locus=Locus(fields[2], fields[0], start, int(info["END"]),
                            offsets + start, alleles),
                haplotypes=haps, sequences=seqs,
                frequencies=None if freqs is None else np.array(freqs.split(","), float),
            ))
    return out


def haplotype_alleles(locus, sequence):
    """A haplotype sequence over the locus interval as its allele vector
    (-1 at an SNV whose character is none of the SNV's alleles)."""
    offsets = locus.positions - locus.start
    return np.array([a.index(sequence[o]) if sequence[o] in a else -1
                     for o, a in zip(offsets, locus.alleles)], np.int64)
