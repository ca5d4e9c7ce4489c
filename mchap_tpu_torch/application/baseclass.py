"""The locus pipeline every tool shares: blocks of loci, reads -> VCF.

Semantics of reference ``mchap/application/baseclass.py``: the same
stats (RCOUNT/DP/SNVDP/RCALLS), read dedup, INFO reductions (AC/AN/UAN/
NS/MCI/DP/RCOUNT and the ACP/AFP/AOP/AOPSUM/SNVDP population pools —
AOP combining per-sample occurrence as 1 - prod(1 - p)), and the same
error wrapping naming the offending locus/sample.

Port of ``mchap_tpu/application/baseclass.py``.  The reference
parallelizes with a multiprocessing pool per locus block; here
``run_stdout`` takes the loci in blocks of ``--locus-batch`` and
``_call_locus_block`` is the one loop every tool runs them through, at
any block size: each locus's reads are encoded and the tool's
``_setup_locus`` decides what it needs, one ``_fit_block`` call fits
the whole block on the device, and ``_finish_locus`` writes each
locus's posterior fields before its record is formatted.  ``--cores``
shapes nothing (batching across loci supersedes process parallelism).  ``device`` is resolved once, at the
entry point.
"""

import sys
import warnings
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from mchap_tpu_torch import mset
from mchap_tpu_torch.utils import timing
from mchap_tpu_torch.constant import PFEIFFER_ERROR
from mchap_tpu_torch.encoding import character
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.bam import (
    encode_read_alleles,
    encode_read_distributions,
    extract_read_variants,
)
from mchap_tpu_torch.io.bamlite import AlignmentFile
from mchap_tpu_torch.io.loci import Locus
from mchap_tpu_torch.io.vcflite import VariantFile
from mchap_tpu_torch.parallel.distributed import is_output_process

warnings.simplefilter("error", RuntimeWarning)

LOCUS_ASSEMBLY_ERROR = (
    "Exception encountered at locus: '{name}', '{contig}:{start}-{stop}'."
)
SAMPLE_ASSEMBLY_ERROR = "Exception encountered when assembling sample '{sample}'."


class LocusAssemblyError(Exception):
    pass


class SampleAssemblyError(Exception):
    pass


@contextmanager
def locus_errors(locus):
    """Raise what fails inside as a LocusAssemblyError naming ``locus``."""
    try:
        yield
    except Exception as e:
        message = LOCUS_ASSEMBLY_ERROR.format(
            name=locus.name, contig=locus.contig, start=locus.start, stop=locus.stop
        )
        raise LocusAssemblyError(message) from e


@contextmanager
def sample_errors(sample):
    """Raise what fails inside as a SampleAssemblyError naming ``sample``."""
    try:
        yield
    except Exception as e:
        raise SampleAssemblyError(SAMPLE_ASSEMBLY_ERROR.format(sample=sample)) from e


# column keys
CHROM, POS, ID, REF, ALT, QUAL, FILTER = (
    "CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
)


@dataclass
class program:
    vcf: str
    ref: str
    samples: list
    sample_bams: dict
    sample_ploidy: dict
    sample_inbreeding: dict
    read_group_field: str = "SM"
    base_error_rate: float = PFEIFFER_ERROR
    ignore_base_phred_scores: bool = True
    mapping_quality: int = 20
    skip_duplicates: bool = True
    skip_qcfail: bool = True
    skip_supplementary: bool = True
    info_fields: list = None
    format_fields: list = None
    n_cores: int = 1
    locus_batch: str = "auto"
    device: torch.device = torch.device("cuda")
    precision: int = 3
    random_seed: int = 42
    cli_command: str = None

    @classmethod
    def cli(cls, command):
        raise NotImplementedError()

    def require_AFP(self):
        if {VCF.INFO_ACP, VCF.INFO_AFP, VCF.INFO_AOP, VCF.INFO_AOPSUM} & set(
            self.info_fields
        ):
            return True
        if {VCF.FORMAT_ACP, VCF.FORMAT_AFP, VCF.FORMAT_AOP} & set(self.format_fields):
            return True
        return False

    def loci(self):
        raise NotImplementedError()

    def _alignment_file(self, path):
        """Cached alignment handles: the standalone reader decodes and
        position-indexes a file once, so re-opening per locus x sample
        (the reference's pattern, viable there because htslib seeks via
        the .bai index) would re-decode the whole BAM every time."""
        cache = getattr(self, "_alignment_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_alignment_cache", cache)
        if path not in cache:
            cache[path] = AlignmentFile(path, reference_filename=self.ref)
        return cache[path]

    def header_contigs(self):
        contigs = []
        with VariantFile(self.vcf) as f:
            for line in f.header_lines:
                if line.startswith("##contig=<"):
                    body = line[line.index("<") + 1 : line.rindex(">")]
                    fields = dict(
                        part.split("=", 1) for part in body.split(",") if "=" in part
                    )
                    length = fields.get("length")
                    contigs.append(
                        VCF.ContigHeader(
                            fields.get("ID"), int(length) if length else None
                        )
                    )
        return contigs

    def header(self):
        meta_fields = [
            VCF.fileformat("v4.3"),
            VCF.filedate(),
            VCF.source(),
            VCF.phasing("None"),
            VCF.commandline(self.cli_command),
            VCF.randomseed(self.random_seed),
        ]
        header = (
            meta_fields
            + self.header_contigs()
            + [VCF.PASS, VCF.NOA, VCF.AF0]
            + self.info_fields
            + self.format_fields
            + [VCF.columns(self.samples)]
        )
        return [str(line) for line in header]

    def _locus_data(self, locus, sample_bams):
        return LocusAssemblyData(
            locus=locus,
            samples=self.samples,
            sample_bams=sample_bams,
            sample_ploidy=self.sample_ploidy,
            sample_inbreeding=self.sample_inbreeding,
            read_calls=dict(),
            read_dists=dict(),
            read_counts=dict(),
            infofields=self.info_fields.copy(),
            formatfields=self.format_fields.copy(),
            columndata=dict(FILTER=list()),
            infodata={f: {} for f in VCF.INFO_ALL_FIELDS},
            sampledata={f: {} for f in VCF.FORMAT_ALL_FIELDS},
            precision=self.precision,
        )

    def _extract_sample_reads(self, data, sample):
        """The (chars, quals) of one sample's reads at the locus's SNVs,
        over each of its alignment files."""
        pairs = data.sample_bams[sample]
        read_chars, read_quals = [], []
        for name, path in pairs:
            alignment_file = self._alignment_file(path)
            chars, quals = extract_read_variants(
                data.locus,
                alignment_file=alignment_file,
                samples=name,
                id=self.read_group_field,
                min_quality=self.mapping_quality,
                skip_duplicates=self.skip_duplicates,
                skip_qcfail=self.skip_qcfail,
                skip_supplementary=self.skip_supplementary,
            )[name]
            read_chars.append(chars)
            read_quals.append(quals)
        if len(pairs) > 0:
            return np.concatenate(read_chars), np.concatenate(read_quals)
        shape = (0, len(data.locus.variants))
        return np.empty(shape, dtype="U1"), np.empty(shape, dtype=np.int16)

    def encode_sample_reads(self, data):
        """Extract, encode, and de-duplicate reads per (pooled) sample.

        Reference: baseclass.py:134-215.
        """
        locus = data.locus
        for sample in data.samples:
            with sample_errors(sample):
                with timing.stage("io.read_extract", locus=locus.name, sample=sample):
                    read_chars, read_quals = self._extract_sample_reads(data, sample)
                read_count = read_chars.shape[0]
                timing.count("io.reads_extracted", read_count)
                with timing.stage("encoding.reads", locus=locus.name, sample=sample):
                    data.sampledata[VCF.FORMAT_RCOUNT][sample] = read_count
                    read_variant_depth = character.depth(read_chars)
                    if len(read_variant_depth) == 0:
                        read_variant_depth = np.array(np.nan)
                    data.sampledata[VCF.FORMAT_DP][sample] = np.round(
                        np.mean(read_variant_depth)
                    )
                    data.sampledata[VCF.FORMAT_SNVDP][sample] = np.round(read_variant_depth)

                    read_calls = encode_read_alleles(locus, read_chars)
                    data.read_calls[sample] = read_calls
                    if self.ignore_base_phred_scores:
                        read_quals = None
                    read_dists = encode_read_distributions(
                        locus, read_calls, read_quals, error_rate=self.base_error_rate
                    )
                    data.sampledata[VCF.FORMAT_RCALLS][sample] = np.sum(read_calls >= 0)

                    # de-duplicate reads: dedup over integer calls + qual matrix
                    # (equivalent to the reference's dedup over the float
                    # distributions, baseclass.py:207-209, since the encoding is
                    # a function of calls and quals)
                    read_dists_unique, read_dist_counts = _unique_read_dists(read_dists)
                    data.read_dists[sample] = read_dists_unique
                    data.read_counts[sample] = read_dist_counts
                timing.count("encoding.unique_reads", len(read_dist_counts))
        return data

    def sumarise_vcf_record(self, data):
        """Population INFO reductions; reference baseclass.py:220-302.

        (Name kept as in the reference API.)
        """
        data.columndata[CHROM] = data.locus.contig
        data.columndata[POS] = data.locus.start + 1
        data.columndata[ID] = data.locus.name
        data.columndata[QUAL] = np.nan
        data.infodata[VCF.INFO_END] = data.locus.stop
        data.infodata[VCF.INFO_NVAR] = len(data.locus.variants)
        data.infodata[VCF.INFO_SNVPOS] = (
            np.subtract(data.locus.positions, data.locus.start) + 1
        )
        if len(data.columndata[FILTER]) == 0:
            data.columndata[FILTER] = VCF.PASS.id
        allele_counts = np.zeros(len(data.columndata[ALT]) + 1, int)
        for array in data.sampledata[VCF.FORMAT_GT].values():
            for a in array:
                if a >= 0:
                    allele_counts[a] += 1
        data.infodata[VCF.INFO_AC] = allele_counts[1:]
        data.infodata[VCF.INFO_AN] = np.sum(allele_counts)
        data.infodata[VCF.INFO_UAN] = np.sum(allele_counts > 0)
        data.infodata[VCF.INFO_NS] = sum(
            np.any(a >= 0) for a in data.sampledata[VCF.FORMAT_GT].values()
        )
        data.infodata[VCF.INFO_MCI] = sum(
            mci > 0 for mci in data.sampledata[VCF.FORMAT_MCI].values()
        )
        if len(data.locus.variants) == 0:
            data.infodata[VCF.INFO_DP] = np.nan
        else:
            data.infodata[VCF.INFO_DP] = np.nansum(
                list(data.sampledata[VCF.FORMAT_DP].values())
            )
        data.infodata[VCF.INFO_RCOUNT] = np.nansum(
            list(data.sampledata[VCF.FORMAT_RCOUNT].values())
        )
        n_allele = len(data.columndata[ALT]) + 1
        null_length_R = np.full(n_allele, np.nan)
        if VCF.INFO_ACP in data.infofields:
            _ACP = sum(data.sampledata[VCF.FORMAT_ACP].values())
            _ACP = null_length_R if np.isnan(_ACP).all() else _ACP
            data.infodata[VCF.INFO_ACP] = _ACP
        if VCF.INFO_AFP in data.infofields:
            _AFP = sum(data.sampledata[VCF.FORMAT_ACP].values()) / sum(
                data.sample_ploidy.values()
            )
            _AFP = null_length_R if np.isnan(_AFP).all() else _AFP
            data.infodata[VCF.INFO_AFP] = _AFP
        if VCF.INFO_AOPSUM in data.infofields:
            _AOPSUM = sum(data.sampledata[VCF.FORMAT_AOP].values())
            _AOPSUM = null_length_R if np.isnan(_AOPSUM).all() else _AOPSUM
            data.infodata[VCF.INFO_AOPSUM] = _AOPSUM
        if VCF.INFO_AOP in data.infofields:
            prob_not_occurring = np.ones(n_allele, float)
            for occur in data.sampledata[VCF.FORMAT_AOP].values():
                prob_not_occurring = prob_not_occurring * (1 - occur)
            data.infodata[VCF.INFO_AOP] = 1 - prob_not_occurring
        if VCF.INFO_SNVDP in data.infofields:
            data.infodata[VCF.INFO_SNVDP] = sum(
                data.sampledata[VCF.FORMAT_SNVDP].values()
            )
        return data

    # -- the block loop and the tools' hooks -----------------------------

    def _setup_locus(self, data):
        """What the tool decides from one locus's input before any device
        work (panel masking, filters, route); handed to ``_fit_block``
        and ``_finish_locus`` as the locus's ``setup`` (by default
        nothing)."""
        return None

    def _fit_block(self, prepared):
        """Fit the block on the device: ``prepared`` lists each locus's
        (data, setup).  Returns what each locus's ``_finish_locus``
        needs, by the locus's place in the block (a locus with nothing
        fitted may be left out)."""
        raise NotImplementedError()

    def _finish_locus(self, data, setup, fitted):
        """Write one locus's posterior fields into ``data``."""
        raise NotImplementedError()

    def _call_locus_block(self, loci):
        """Run a block of loci from reads to formatted VCF records, in
        input order; each failure names its locus or sample once."""
        prepared = []
        with timing.stage("encode_reads"):
            for locus in loci:
                with locus_errors(locus):
                    data = self._locus_data(locus, self.sample_bams)
                    self.encode_sample_reads(data)
                    prepared.append((data, self._setup_locus(data)))
        with timing.stage("device_sampler"):
            fitted = self._fit_block(prepared)
        records = []
        with timing.stage("summarize_format"):
            for idx, (data, setup) in enumerate(prepared):
                name = data.locus.name
                with locus_errors(data.locus):
                    with timing.stage("posterior.samples", locus=name):
                        self._finish_locus(data, setup, fitted.get(idx))
                    with timing.stage("vcf.record", locus=name):
                        self.sumarise_vcf_record(data)
                        records.append(data.format_vcf_record())
                timing.tick_loci(1, sample_calls=len(data.samples))
        return records

    def _locus_batch_size(self):
        """Loci per block: ``--locus-batch``, where "auto" is 32."""
        value = self.locus_batch or "auto"
        return 32 if str(value).lower() == "auto" else max(int(value), 1)

    def _timed_loci(self):
        """Iterate self.loci() charging construction to ``read_loci``."""
        it = iter(self.loci())
        while True:
            with timing.stage("read_loci"):
                try:
                    locus = next(it)
                except StopIteration:
                    return
            yield locus

    def _locus_blocks(self, size):
        """The loci in lists of ``size`` (the last may be shorter)."""
        pending = []
        for locus in self._timed_loci():
            pending.append(locus)
            if len(pending) >= size:
                yield pending
                pending = []
        if pending:
            yield pending

    def run_stdout(self):
        if self.n_cores and self.n_cores > 1:
            warnings.warn(
                "--cores is ignored: cross-locus device batching "
                "supersedes process parallelism (see --locus-batch)."
            )
        # in a process group every rank computes the whole result
        # (parallel/sharding.gather_result), so only one writes it
        output = is_output_process()
        emit = sys.stdout.write if output else (lambda line: None)
        block = self._locus_batch_size()
        for line in self.header():
            emit(line + "\n")
        for index, loci in enumerate(self._locus_blocks(block)):
            with timing.stage("block", block=index, loci=len(loci)):
                lines = self._call_locus_block(loci)
            for line in lines:
                emit(line + "\n")
        if output:
            timing.report()


def _unique_read_dists(read_dists):
    """De-duplicate probabilistic reads (rows hashed by bytes).

    Equivalent to reference ``mset.unique_counts`` over the float read
    tensor (baseclass.py:207-209).
    """
    n = len(read_dists)
    width = int(np.prod(read_dists.shape[1:]))
    flat = read_dists.reshape(n, width)
    # nan != nan breaks row comparison; compare via byte view
    view = np.ascontiguousarray(flat).view(np.uint8).reshape(n, width * 8)
    uniq_rows, counts = mset.unique_counts(view)
    # recover original rows by first-occurrence index
    idx = mset.unique_idx(view)
    return read_dists[idx], counts


@dataclass
class LocusAssemblyData:
    locus: Locus
    samples: list
    sample_bams: dict
    sample_ploidy: dict
    sample_inbreeding: dict
    read_calls: dict
    read_dists: dict
    read_counts: dict
    infofields: list
    formatfields: list
    columndata: dict
    infodata: dict
    sampledata: dict
    precision: float = 3

    def _sampledata_as_list(self, field):
        data = self.sampledata[field]
        return [data.get(s) for s in self.samples]

    def format_vcf_record(self):
        kwargs = {f.id: self.infodata[f] for f in self.infofields}
        info_string = VCF.format_info_field(precision=self.precision, **kwargs)
        kwargs = {f.id: self._sampledata_as_list(f) for f in self.formatfields}
        format_string = VCF.format_sample_field(precision=self.precision, **kwargs)
        return VCF.format_record(
            chrom=self.columndata[CHROM],
            pos=self.columndata[POS],
            id=self.columndata[ID],
            ref=self.columndata[REF],
            alt=self.columndata[ALT],
            qual=self.columndata[QUAL],
            filter=self.columndata[FILTER],
            info=info_string,
            format=format_string,
            precision=self.precision,
        )
