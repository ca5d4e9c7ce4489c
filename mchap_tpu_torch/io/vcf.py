"""VCF v4.3 text emission: headers, field definitions, value formatting.

Covers reference ``mchap/io/vcf/`` (util.py, records.py, headermeta.py,
contigs.py, filters.py, infofields.py, formatfields.py).  The header
field *strings* (IDs, Numbers, Types, Descriptions) and the value
formatting rules (precision-3 rounding, nan -> '.', GT joined with '/')
define the user-visible output contract and therefore match the
reference's output exactly.
"""

from dataclasses import dataclass
from datetime import date as _date

import numpy as np

from mchap_tpu_torch.io.util import qual_of_prob

# ---------------------------------------------------------------------------
# value stringification (reference io/vcf/util.py:4-42)
# ---------------------------------------------------------------------------


def _float_cell(x, precision):
    """One float as VCF text: round, str, trim a trailing '.0'.

    The trim is TEXTUAL, not numeric: a negative zero renders '-0'
    (str(-0.0) = '-0.0' minus the suffix), never '0', and values are
    truncated to 16 characters before trimming — both observable quirks
    of the reference output (io/vcf/util.py:4-42 rounds then casts the
    array to U16 and strips '.0' with string replaces) that the golden
    VCFs pin byte-for-byte.
    """
    x = np.round(x, precision)
    if np.isnan(x):
        return "."
    s = str(x)[:16]
    return s[:-2] if s.endswith(".0") else s


def vcfstr(obj, precision=3):
    """Format a value for VCF output: precision-3 floats with trailing
    '.0' trimmed, nan/None/empty -> '.', iterables comma-joined.

    Byte-compatible with reference ``io/vcf/util.py:4-42`` (verified by
    the golden-VCF suite and ``tests/test_vcf_format.py``), written as a
    per-cell formatter rather than the reference's whole-string
    replace pipeline.
    """
    # scalars ---------------------------------------------------------
    if isinstance(obj, np.ndarray) and obj.ndim == 0:
        obj = obj.item()
    if obj is None:
        return "."
    if isinstance(obj, str):
        return obj if obj else "."
    if isinstance(obj, float):
        # scalar floats go through int(), NOT the textual trim: a scalar
        # -0.0 renders '0' where a float-ARRAY element renders '-0'
        # (reference scalar branch io/vcf/util.py:32-39 vs array branch
        # :9-16 — an asymmetry the byte contract preserves).  Matches
        # ``isinstance(obj, float)`` exactly: np.float64 is a float
        # subclass and lands here, but an np.float32 scalar falls
        # through to str() ('1.0') just as in the reference.
        if np.isnan(obj):
            return "."
        r = np.round(obj, precision)
        i = int(r)
        return str(i) if i == r else str(r)
    if not hasattr(obj, "__iter__"):
        return str(obj)  # ints, bools, anything str-able

    # sequences -------------------------------------------------------
    cells = (
        obj
        if isinstance(obj, np.ndarray)
        else np.asarray(list(obj), dtype=object)
    )
    if len(cells) == 0:
        return "."
    if np.issubdtype(cells.dtype, np.floating):
        return ",".join(_float_cell(x, precision) for x in cells)
    if np.issubdtype(cells.dtype, np.integer):
        return ",".join(str(x) for x in cells)
    return ",".join(vcfstr(x, precision=precision) for x in cells)


# ---------------------------------------------------------------------------
# record assembly (reference io/vcf/records.py)
# ---------------------------------------------------------------------------


def format_info_field(precision=3, **kwargs):
    """Key-value pairs -> INFO string; flags included when True."""
    parts = []
    for k, v in kwargs.items():
        if isinstance(v, bool):
            if v is True:
                parts.append(k)
        else:
            parts.append("{}={}".format(k, vcfstr(v, precision=precision)))
    return ";".join(parts)


def format_sample_field(precision=3, **kwargs):
    """Per-sample arrays -> 'FORMAT\\tS1\\tS2...' columns; GT special-cased
    as '/'-joined with '.' for null alleles."""
    genotypes = kwargs["GT"]
    kwargs["GT"] = [
        "/".join([str(a) if a >= 0 else "." for a in g]) for g in genotypes
    ]
    fields, arrays = zip(*kwargs.items())
    field_string = ":".join(fields)
    lengths = {len(a) for a in arrays}
    assert len(lengths) == 1
    n = lengths.pop()
    sample_data = "\t".join(
        ":".join(vcfstr(a[i], precision=precision) for a in arrays) for i in range(n)
    )
    return "{}\t{}".format(field_string, sample_data)


def format_record(chrom, pos, id, ref, alt, qual, filter, info, format, precision=3):
    """Assemble a full VCF record line."""
    fields = [chrom, pos, id, ref, alt, qual, filter, info, format]
    return "\t".join(vcfstr(f, precision=precision) for f in fields)


# ---------------------------------------------------------------------------
# meta headers (reference io/vcf/headermeta.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MetaHeader:
    id: str
    descr: str

    def __str__(self):
        return "##{id}={descr}".format(id=self.id, descr=self.descr)


def fileformat(version):
    return MetaHeader("fileformat", "VCF{}".format(version))


def filedate(date=None):
    if date is None:
        today = _date.today()
        date = "{}{:02d}{:02d}".format(today.year, today.month, today.day)
    return MetaHeader("fileDate", date)


def source(src=None):
    if src is None:
        from mchap_tpu_torch import __version__

        src = "mchap v{}".format(__version__)
    return MetaHeader("source", src)


def commandline(command):
    if not isinstance(command, str):
        command = '"{}"'.format(" ".join(command))
    return MetaHeader("commandline", command)


def randomseed(seed):
    return MetaHeader("randomseed", str(seed))


def reference(path):
    return MetaHeader("reference", "file:{}".format(path))


def phasing(string):
    return MetaHeader("phasing", string)


def columns(samples):
    cols = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT"]
    return "#" + "\t".join(cols) + "\t" + "\t".join(samples)


@dataclass(frozen=True)
class ContigHeader:
    id: str
    length: int

    def __str__(self):
        length = "." if self.length is None else self.length
        return "##contig=<ID={id},length={length}>".format(id=self.id, length=length)


# ---------------------------------------------------------------------------
# filters (reference io/vcf/filters.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VariantFilter:
    id: str
    descr: str

    def __str__(self):
        return '##FILTER=<ID={id},Description="{descr}">'.format(
            id=self.id, descr=self.descr
        )


PASS = VariantFilter("PASS", "All filters passed")
NOA = VariantFilter("NOA", "No observed alleles at locus")
AF0 = VariantFilter("AF0", "All alleles have prior allele frequency of zero")

VARIANT_FILTERS = dict(PASS=PASS, NOA=NOA, AF0=AF0)


# ---------------------------------------------------------------------------
# INFO field definitions (reference io/vcf/infofields.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InfoField:
    id: str
    number: object
    type: str
    descr: str

    def __str__(self):
        return '##INFO=<ID={id},Number={number},Type={type},Description="{descr}">'.format(
            id=self.id, number=self.number, type=self.type, descr=self.descr
        )


INFO_NS = InfoField("NS", 1, "Integer", "Number of samples with data")
INFO_DP = InfoField("DP", 1, "Integer", "Combined depth across samples")
INFO_PS = InfoField("PS", 1, "Integer", "Phased set for all samples")
INFO_AC = InfoField(
    "AC",
    "A",
    "Integer",
    "Allele count in genotypes, for each ALT allele, in the same order as listed",
)
INFO_AN = InfoField("AN", 1, "Integer", "Total number of alleles in called genotypes")
INFO_UAN = InfoField(
    "UAN", 1, "Integer", "Total number of unique alleles in called genotypes"
)
INFO_MCI = InfoField(
    "MCI", 1, "Integer", "Number of samples with incongruent Markov chain replicates"
)
INFO_AF = InfoField("AF", "A", "Float", "Allele Frequency")
INFO_AFP = InfoField("AFP", "R", "Float", "Posterior mean allele frequencies")
INFO_ACP = InfoField("ACP", "R", "Float", "Posterior allele counts")
INFO_AFPRIOR = InfoField("AFPRIOR", "R", "Float", "Prior allele frequencies")
INFO_AOP = InfoField(
    "AOP", "R", "Float", "Posterior probability of allele occurring across all samples"
)
INFO_AOPSUM = InfoField(
    "AOPSUM", "R", "Float", "Posterior estimate of the number of samples containing an allele"
)
INFO_AA = InfoField("AA", 1, "String", "Ancestral allele")
INFO_END = InfoField("END", 1, "Integer", "End position on CHROM")
INFO_NVAR = InfoField(
    "NVAR", 1, "Integer", "Number of input variants within assembly locus"
)
INFO_SNVPOS = InfoField(
    "SNVPOS", ".", "Integer", "Relative (1-based) positions of SNVs within haplotypes"
)
INFO_AD = InfoField("AD", "R", "Integer", "Total read depth for each allele")
INFO_ADMF = InfoField(
    "ADMF", "R", "Float", "Mean of sample allele frequencies calculated from read depth"
)
INFO_RCOUNT = InfoField(
    "RCOUNT", 1, "Integer", "Total number of observed reads across all samples"
)
INFO_REFMASKED = InfoField("REFMASKED", 0, "Flag", "Reference allele is masked")
INFO_SNVDP = InfoField("SNVDP", ".", "Integer", "Read depth at each SNV position")

INFO_DEFAULT_FIELDS = [
    INFO_AN,
    INFO_UAN,
    INFO_AC,
    INFO_REFMASKED,
    INFO_NS,
    INFO_MCI,
    INFO_DP,
    INFO_RCOUNT,
    INFO_END,
    INFO_NVAR,
    INFO_SNVPOS,
]
INFO_OPTIONAL_FIELDS = [INFO_AFPRIOR, INFO_ACP, INFO_AFP, INFO_AOP, INFO_AOPSUM, INFO_SNVDP]
INFO_ALL_FIELDS = INFO_DEFAULT_FIELDS + INFO_OPTIONAL_FIELDS


# ---------------------------------------------------------------------------
# FORMAT field definitions (reference io/vcf/formatfields.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FormatField:
    id: str
    number: object
    type: str
    descr: str

    def __str__(self):
        return '##FORMAT=<ID={id},Number={number},Type={type},Description="{descr}">'.format(
            id=self.id, number=self.number, type=self.type, descr=self.descr
        )


FORMAT_GT = FormatField("GT", 1, "String", "Genotype")
FORMAT_GQ = FormatField("GQ", 1, "Integer", "Genotype quality")
FORMAT_SQ = FormatField("SQ", 1, "Integer", "Genotype support quality")
FORMAT_DP = FormatField("DP", 1, "Integer", "Read depth")
FORMAT_PS = FormatField("PS", 1, "Integer", "Phase set")
FORMAT_PQ = FormatField("PQ", 1, "Integer", "Phasing quality")
FORMAT_DS = FormatField("DS", "A", "Float", "Posterior mean dosage")
FORMAT_FT = FormatField(
    "FT", 1, "String", "Filter indicating if this genotype was called"
)
FORMAT_RCOUNT = FormatField(
    "RCOUNT", 1, "Integer", "Total count of read pairs within haplotype interval"
)
FORMAT_RCALLS = FormatField(
    "RCALLS", 1, "Integer", "Total count of read base calls matching a known variant"
)
FORMAT_GPM = FormatField("GPM", 1, "Float", "Genotype posterior mode probability")
FORMAT_SPM = FormatField(
    "SPM", 1, "Float", "Genotype support posterior mode probability"
)
FORMAT_DOSEXP = FormatField(
    "DOSEXP", ".", "Float", "Mode genotype support expected dosage"
)
FORMAT_MEC = FormatField("MEC", 1, "Integer", "Minimum error correction")
FORMAT_MECP = FormatField("MECP", 1, "Float", "Minimum error correction proportion")
FORMAT_AD = FormatField("AD", "R", "Integer", "Read depth for each allele")
FORMAT_GL = FormatField("GL", "G", "Float", "Genotype likelihoods")
FORMAT_GP = FormatField("GP", "G", "Float", "Genotype posterior probabilities")
FORMAT_ACP = FormatField("ACP", "R", "Float", "Posterior allele counts")
FORMAT_AFP = FormatField("AFP", "R", "Float", "Posterior mean allele frequencies")
FORMAT_AOP = FormatField(
    "AOP", "R", "Float", "Posterior probability of allele occurring"
)
FORMAT_MCI = FormatField(
    "MCI",
    1,
    "Integer",
    "Replicate Markov-chain incongruence, 0 = none, 1 = incongruence, 2 = putative CNV",
)
FORMAT_KMERCOV = FormatField(
    "KMERCOV",
    3,
    "Float",
    "Minimum proportion of read-SNV 1-, 2-, and 3-mers found in genotype at any position.",
)
FORMAT_MCAP = FormatField(
    "MCAP", "R", "Float", "Posterior probability of allele-presence from assembly MCMC"
)
FORMAT_SNVDP = FormatField(
    "SNVDP", ".", "Integer", "Read depth at each SNV position"
)
FORMAT_PEDERR = FormatField(
    "PEDERR",
    1,
    "Float",
    "Posterior probability of pedigree error between an individual and its specified parents",
)

FORMAT_DEFAULT_FIELDS = [
    FORMAT_GT,
    FORMAT_GQ,
    FORMAT_SQ,
    FORMAT_DP,
    FORMAT_RCOUNT,
    FORMAT_RCALLS,
    FORMAT_MEC,
    FORMAT_MECP,
    FORMAT_GPM,
    FORMAT_SPM,
    FORMAT_MCI,
]
FORMAT_OPTIONAL_FIELDS = [
    FORMAT_ACP,
    FORMAT_AFP,
    FORMAT_AOP,
    FORMAT_GP,
    FORMAT_GL,
    FORMAT_SNVDP,
]
FORMAT_PEDIGREE_FIELDS = [FORMAT_PEDERR]
FORMAT_ALL_FIELDS = FORMAT_DEFAULT_FIELDS + FORMAT_OPTIONAL_FIELDS + FORMAT_PEDIGREE_FIELDS


# ---------------------------------------------------------------------------
# small helpers (reference formatfields.py:166-189)
# ---------------------------------------------------------------------------


def haplotype_depth(variant_depths):
    if len(variant_depths) == 0:
        return None
    return int(np.mean(variant_depths))


def quality(prob):
    if prob is None:
        return None
    return qual_of_prob(prob)


def probabilities(obj, decimals):
    if hasattr(obj, "__iter__"):
        return [probabilities(o, decimals) for o in obj]
    if isinstance(obj, float):
        return np.round(obj, decimals)
    return obj
