"""``io/bam.extract_read_variants``: the port reads each SNV off a read's
CIGAR blocks and MD mismatches, batched over the reads of one (locus,
file).  Held here to ``mchap_tpu``'s copy, which walks every aligned
base of every read, on SAM and BAM files written by the test: the same
(chars, quals) per sample, or the same error text."""

import struct
import zlib

import numpy as np
import pytest
import torch

from mchap_tpu.io import bam as jax_bam
from mchap_tpu.io import bamlite as jax_bamlite
from mchap_tpu.io import loci as jax_loci
from mchap_tpu.io.bed import read_bed4 as jax_read_bed4
from mchap_tpu_torch.io import bam, bamlite, loci
from mchap_tpu_torch.io.bed import read_bed4
from mchap_tpu_torch.io.indexing import reg2bin
from test_torch_fixtures import write_dataset

torch.set_num_threads(1)

REF = "".join(np.random.default_rng(5).choice(list("ACGT"), 90))
#: SNV position -> its alternate alleles (two at 37); the locus is [10, 60)
SNVS = {p: tuple(b for b in "ACGT" if b != REF[p])[: 2 if p == 37 else 1]
        for p in (12, 15, 16, 22, 30, 37, 44, 52, 57)}
OTHER = {p: "ACGT"[("ACGT".index(REF[p]) + 2) % 4] for p in SNVS}  # neither REF nor alt
FILLER = "TGCAAGTC"  # the bases of insertions and soft clips


def _ops(cigar):
    out, num = [], ""
    for c in cigar:
        if c.isdigit():
            num += c
        else:
            out.append((c, int(num)))
            num = ""
    return out


def read(qname, pos, cigar, alts=(), rg="rg1", flag=0, mapq=60, md=True, bases=None):
    """One alignment of the haplotype that carries the first alternate
    allele at ``alts`` (and any base of ``bases``, by position) to REF,
    its MD computed from the alignment unless given (``None``: no MD)."""
    hap = list(REF)
    for p in alts:
        hap[p] = SNVS[p][0]
    for p, b in (bases or {}).items():
        hap[p] = b
    seq, tag, run, ref_i = [], [], 0, pos
    for op, ln in _ops(cigar):
        if op in "M=X":
            for _ in range(ln):
                seq.append(hap[ref_i])
                if hap[ref_i] == REF[ref_i]:
                    run += 1
                else:
                    tag.append(f"{run}{REF[ref_i]}")
                    run = 0
                ref_i += 1
        elif op in "IS":
            seq.extend(FILLER[(len(seq) + k) % len(FILLER)] for k in range(ln))
        elif op == "D":
            tag.append(f"{run}^{REF[ref_i:ref_i + ln]}")
            run = 0
            ref_i += ln
        elif op == "N":
            ref_i += ln
    tags = [("RG", rg)]
    if md is True:
        tags.append(("MD", "".join(tag) + str(run)))
    elif md is not None:
        tags.append(("MD", md))
    quals = [20 + (7 * i + len(qname)) % 21 for i in range(len(seq))]
    return dict(qname=qname, flag=flag, pos=pos, mapq=mapq, cigar=cigar,
                seq="".join(seq), quals=quals, tags=tags, end=ref_i)


RGS = [("rg1", "s1"), ("rg2", "s2"), ("rg3", "s1")]


def _header(rgs):
    lines = ["@HD\tVN:1.6\tSO:coordinate", f"@SQ\tSN:chr1\tLN:{len(REF)}"]
    return "\n".join(lines + [f"@RG\tID:{i}\tSM:{s}" for i, s in rgs]) + "\n"


def write_sam(path, reads, rgs=RGS):
    lines = [
        f"{r['qname']}\t{r['flag']}\tchr1\t{r['pos'] + 1}\t{r['mapq']}\t{r['cigar']}"
        f"\t*\t0\t0\t{r['seq']}\t{''.join(chr(q + 33) for q in r['quals'])}\t"
        + "\t".join(f"{t}:Z:{v}" for t, v in r["tags"])
        for r in reads
    ]
    path.write_text(_header(rgs) + "".join(line + "\n" for line in lines))


def _bgzf(data):
    deflate = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = deflate.compress(data) + deflate.flush()
    head = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2, len(body) + 25)
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def write_bam(path, reads, rgs=RGS):
    text = _header(rgs).encode()
    out = [b"BAM\x01", struct.pack("<i", len(text)), text, struct.pack("<ii", 1, 5),
           b"chr1\x00", struct.pack("<i", len(REF))]
    for r in reads:
        name = r["qname"].encode() + b"\x00"
        ops = _ops(r["cigar"])
        codes = ["=ACMGRSVTWYHKDBN".index(c) for c in r["seq"]] + [0]
        body = b"".join([
            struct.pack("<iiBBHHHiiii", 0, r["pos"], len(name), r["mapq"],
                        reg2bin(r["pos"], r["end"]), len(ops), r["flag"], len(r["seq"]),
                        -1, -1, 0),
            name,
            b"".join(struct.pack("<I", ln << 4 | "MIDNSHP=X".index(op)) for op, ln in ops),
            bytes(codes[i] << 4 | codes[i + 1] for i in range(0, len(r["seq"]), 2)),
            bytes(r["quals"]),
            b"".join(t.encode() + b"Z" + v.encode() + b"\x00" for t, v in r["tags"]),
        ])
        out += [struct.pack("<i", len(body)), body]
    path.write_bytes(_bgzf(b"".join(out)) + _bgzf(b""))


def _loci(name="locus", snvs=SNVS, lower=False):
    """The locus [10, 60) in each package's Locus class."""
    made = []
    for module in (loci, jax_loci):
        variants = tuple(
            module.SNP("chr1", p, p + 1, ".",
                       tuple(a.lower() if lower else a for a in (REF[p],) + tuple(alts)))
            for p, alts in snvs.items()
        )
        made.append(module.Locus("chr1", 10, 60, name, REF[10:60], variants))
    return made


CASES = {
    "ungapped": [
        read("a", 5, "30M", alts=[12]),
        read("b", 10, "50M", alts=[15, 16, 30]),
        read("c", 20, "25M"),
        read("d", 40, "35M", alts=[44, 57]),
    ],
    "clips": [
        read("a", 10, "3S20M2S", alts=[22]),
        read("b", 14, "5H20M4H", alts=[16, 22]),
        read("c", 30, "2H3S15M", alts=[37]),
    ],
    "insertion_beside_snv": [
        read("a", 10, "6M2I10M", alts=[15, 16]),
        read("b", 11, "5M1I1M1I8M", alts=[16]),
        read("c", 25, "5M3I20M", alts=[30]),
    ],
    "deletion_over_snv": [
        read("a", 10, "12M3D10M", alts=[16, 30]),
        read("b", 12, "5M5D10M", alts=[22]),  # MD ...^XXXXX0Y...
    ],
    "n_skip": [
        read("a", 10, "8M20N10M", alts=[12, 44]),
        read("b", 14, "3M5N30M", alts=[30]),
    ],
    "eq_x_ops": [
        read("a", 10, "5=1X1X5=", alts=[15, 16]),
        read("b", 20, "2=1X20=", alts=[22]),
    ],
    "no_md": [
        read("a", 10, "40M", md=None),
        read("b", 12, "10M2D10M", md=None),
        read("c", 25, "4S30M", md=None),
    ],
    "md_deletions_mismatches": [
        read("a", 10, "10M2D5M1I10M", alts=[12, 30]),
        read("b", 14, "2M3D20M", alts=[22, 30]),
        read("c", 40, "4M1D12M", alts=[52, 57]),
    ],
    "mates": [
        read("same", 10, "30M", alts=[15]),
        read("same", 20, "30M", alts=[30]),
        read("split", 10, "30M", alts=[15]),
        read("split", 12, "30M"),
        read("three", 20, "20M", alts=[30]),
        read("three", 22, "20M"),
        read("three", 25, "20M", alts=[30]),
        read("apart", 10, "10M"),
        read("apart", 40, "20M", alts=[44]),
        read("unknown", 25, "10M", bases={30: "N"}),
        read("unknown", 28, "10M", bases={30: "N"}),
        read("other", 10, "30M", rg="rg2", alts=[15]),
        read("other", 10, "30M", rg="rg2"),
    ],
    "read_groups": [
        read("a", 10, "30M", rg="rg1", alts=[15]),
        read("b", 10, "30M", rg="rg2", alts=[16]),
        read("c", 10, "30M", rg="rg3", alts=[22]),
        read("a", 12, "30M", rg="rg3", alts=[22]),
    ],
    "filters": [
        read("unmapped", 10, "30M", flag=0x4),
        read("dup", 10, "30M", flag=0x400, alts=[15]),
        read("qcfail", 11, "30M", flag=0x200, alts=[16]),
        read("supp", 12, "30M", flag=0x800, alts=[22]),
        read("secondary", 13, "30M", flag=0x100, alts=[30]),
        read("lowq", 14, "30M", mapq=10, alts=[37]),
        read("kept", 15, "30M", flag=0x10),
    ],
    "no_reads": [
        read("outside", 62, "20M"),
        read("before", 0, "8M"),
    ],
    "ref_mismatch_md": [
        # the MD claims another reference base at 12 and 30, then at 12
        read("a", 5, "40M", md=f"7{OTHER[12]}17{OTHER[30]}14"),
        read("b", 10, "30M", md=f"2{OTHER[12]}27"),
    ],
    "ref_mismatch_no_md": [
        read("a", 10, "30M"),
        read("b", 14, "20M", alts=[16, 30], md=None),
    ],
}
#: the cases whose every run raises
RAISES = {"ref_mismatch_md", "ref_mismatch_no_md"}

KWARGS = {
    "default": {},
    "sample_s2": dict(samples="s2"),
    "sample_set": dict(samples={"s1"}),
    "by_rg_id": dict(id="ID", samples={"rg3", "rg2"}),
    "keep_flagged": dict(min_quality=5, skip_duplicates=False, skip_qcfail=False,
                         skip_supplementary=False),
}
RUNS = [(case, "default") for case in CASES] + [
    ("read_groups", "sample_s2"), ("read_groups", "sample_set"),
    ("read_groups", "by_rg_id"), ("mates", "sample_s2"), ("filters", "keep_flagged"),
]


def _outcome(extract, locus, alignment_file, **kwargs):
    try:
        return extract(locus, alignment_file, **kwargs)
    except ValueError as error:
        return str(error)


def assert_same(got, want):
    if isinstance(want, str):
        assert got == want
        return
    assert list(got) == list(want)
    for sample in want:
        for a, b in zip(got[sample], want[sample]):
            assert a.dtype == b.dtype and a.shape == b.shape, (sample, a, b)
            np.testing.assert_array_equal(a, b)


def _compare(path, locus_args=(), **kwargs):
    locus, jax_locus = _loci(*locus_args)
    got = _outcome(bam.extract_read_variants, locus, bamlite.AlignmentFile(path), **kwargs)
    want = _outcome(jax_bam.extract_read_variants, jax_locus,
                    jax_bamlite.AlignmentFile(path), **kwargs)
    assert_same(got, want)
    return got


@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("case,kwargs", RUNS, ids=[f"{c}-{k}" for c, k in RUNS])
def test_extract_matches_aligned_pairs(case, kwargs, fmt, tmp_path):
    reads = sorted(CASES[case], key=lambda r: r["pos"])
    path = tmp_path / f"reads.{fmt}"
    (write_sam if fmt == "sam" else write_bam)(path, reads)
    got = _compare(path, **KWARGS[kwargs])
    if case in RAISES:
        assert isinstance(got, str) and "does not match alignment reference" in got
    else:
        assert isinstance(got, dict) and got
        n_called = sum(int((chars != "-").sum()) for chars, _ in got.values())
        assert (n_called == 0) == (case == "no_reads")


@pytest.mark.parametrize("locus_args", [
    ("", SNVS), ("locus", {}), ("locus", SNVS, True),
], ids=["unnamed", "no_snvs", "lowercase_alleles"])
def test_extract_locus_forms(locus_args, tmp_path):
    """An unnamed locus (the error text without its target), a locus
    without SNVs, lowercase reference alleles (compared case-blind)."""
    path = tmp_path / "reads.sam"
    reads = CASES["mates"] + CASES["ref_mismatch_no_md"][1:]
    write_sam(path, sorted(reads, key=lambda r: r["pos"]))
    _compare(path, locus_args)
    write_sam(path, sorted(CASES["ungapped"], key=lambda r: r["pos"]))
    _compare(path, locus_args)


def test_extract_on_written_dataset(tmp_path):
    data = write_dataset(tmp_path, n_samples=3, n_loci=3, reads_per_sample=30,
                         error_rate=0.02, seed=4)
    torch_loci = [b.set_sequence(data["reference"]).set_variants(data["variants"])
                  for b in read_bed4(data["targets"])]
    jax_loci_ = [b.set_sequence(data["reference"]).set_variants(data["variants"])
                 for b in jax_read_bed4(data["targets"])]
    for sample, path in zip(data["samples"], data["bams"]):
        torch_file, jax_file = bamlite.AlignmentFile(path), jax_bamlite.AlignmentFile(path)
        for locus, jax_locus in zip(torch_loci, jax_loci_):
            got = bam.extract_read_variants(locus, torch_file, samples=sample)
            assert_same(got, jax_bam.extract_read_variants(jax_locus, jax_file, samples=sample))
            assert got[sample][0].shape == (30, len(locus.variants))
