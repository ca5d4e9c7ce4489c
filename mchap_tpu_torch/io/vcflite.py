"""Minimal VCF reader (replaces the pysam.VariantFile subset used here).

Reads plain or bgzip/gzip-compressed VCF text; INFO values are typed
using the header declarations (Flag presence, Number=1 scalars, tuples
otherwise) to match the pysam record surface the reference relies on
(``record.info``, ``record.ref``, ``record.alts``, coordinates).
Region fetch is tabix-driven when a ``.tbi``/``.csi`` sits next to a
bgzipped file (the reference's pattern via pysam, ``mchap/io/loci.py``):
only the BGZF blocks overlapping the region are decompressed and
parsed.  Unindexed files are parsed once into per-contig, start-sorted
record lists and regions resolved by binary search — never a rescan of
the file per locus.
"""

import bisect
import gzip
from dataclasses import dataclass, field

from mchap_tpu_torch.io import indexing


def _open_text(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path)


def _typed(value_str, vtype):
    if vtype == "Integer":
        return int(value_str)
    if vtype == "Float":
        return float(value_str)
    return value_str


@dataclass
class VariantRecord:
    chrom: str
    pos: int  # 1-based
    id: str
    ref: str
    alts: tuple
    qual: object
    filter: tuple
    info: dict
    format: tuple = ()
    samples: dict = field(default_factory=dict)
    info_numbers: dict = field(default_factory=dict, repr=False)

    def info_number(self, key):
        """VCF Number declaration ("R", "A", "1", ...) of an INFO field."""
        entry = self.info_numbers.get(key)
        return entry[0] if entry else None

    @property
    def contig(self):
        return self.chrom

    @property
    def start(self):
        return self.pos - 1

    @property
    def stop(self):
        end = self.info.get("END")
        if end is not None:
            return int(end)
        return self.start + len(self.ref)


class VariantFile:
    def __init__(self, path):
        self._path = str(path)
        self._info_types = {}  # ID -> (Number, Type)
        self._format_types = {}
        self.samples = []
        self._header_lines = []
        self._tabix = None  # lazily-loaded .tbi/.csi
        self._tabix_tried = False
        self._bgzf = None
        self._records_by_contig = None  # unindexed fallback cache
        self._parse_header()

    def _parse_header(self):
        with _open_text(self._path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("##"):
                    self._header_lines.append(line)
                    if line.startswith("##INFO=<") or line.startswith("##FORMAT=<"):
                        body = line[line.index("<") + 1 : line.rindex(">")]
                        fields = {}
                        for part in _split_meta(body):
                            if "=" in part:
                                k, v = part.split("=", 1)
                                fields[k] = v.strip('"')
                        target = (
                            self._info_types
                            if line.startswith("##INFO=")
                            else self._format_types
                        )
                        target[fields.get("ID")] = (
                            fields.get("Number", "."),
                            fields.get("Type", "String"),
                        )
                elif line.startswith("#CHROM"):
                    self._header_lines.append(line)
                    cols = line.split("\t")
                    self.samples = cols[9:] if len(cols) > 9 else []
                    break

    @property
    def header_lines(self):
        return list(self._header_lines)

    def _parse_info(self, text):
        info = {}
        if text == "." or text == "":
            return info
        for item in text.split(";"):
            if "=" in item:
                key, val = item.split("=", 1)
                number, vtype = self._info_types.get(key, (".", "String"))
                parts = val.split(",")
                if number == "1":
                    info[key] = _typed(parts[0], vtype) if parts[0] != "." else None
                elif number == "0":
                    info[key] = True
                else:
                    info[key] = tuple(
                        _typed(p, vtype) if p != "." else None for p in parts
                    )
            else:
                info[item] = True  # Flag
        return info

    def _parse_line(self, line):
        fields = line.rstrip("\n").split("\t")
        chrom, pos, vid, ref, alt, qual, filt, info = fields[:8]
        alts = tuple(alt.split(",")) if alt != "." else None
        fmt = tuple(fields[8].split(":")) if len(fields) > 8 else ()
        samples = {}
        for name, cell in zip(self.samples, fields[9:]):
            samples[name] = dict(zip(fmt, cell.split(":")))
        return VariantRecord(
            chrom=chrom,
            pos=int(pos),
            id=None if vid == "." else vid,
            ref=ref,
            alts=alts,
            qual=None if qual == "." else float(qual),
            filter=tuple(filt.split(";")) if filt != "." else (),
            info=self._parse_info(info),
            format=fmt,
            samples=samples,
            info_numbers=self._info_types,
        )

    def _load_tabix(self):
        """Lazily read an on-disk .tbi next to a bgzipped file."""
        if self._tabix_tried:
            return self._tabix
        self._tabix_tried = True
        import os

        tbi = self._path + ".tbi"
        try:
            if os.path.exists(tbi) and indexing.is_bgzf(self._path):
                self._tabix = indexing.read_tbi(tbi)
        except (OSError, ValueError):
            self._tabix = None  # unreadable index: cached-scan path
        return self._tabix

    def _fetch_tabix(self, contig, start, stop):
        """Parse only the BGZF chunks whose lines can overlap
        [start, stop) (tabix binning; parity with pysam fetch)."""
        if self._bgzf is None:
            self._bgzf = indexing.BGZFFile(self._path)
        beg = 0 if start is None else max(0, int(start))
        end = (1 << 29) if stop is None else int(stop)
        for vbeg, vend in self._tabix.chunks(contig, beg, end):
            for line in self._bgzf.stream(vbeg, vend).decode().splitlines():
                if line.startswith("#") or not line.startswith(contig + "\t"):
                    continue
                record = self._parse_line(line)
                if record.chrom != contig:
                    continue
                if start is not None and record.stop <= start:
                    continue
                if stop is not None and record.start >= stop:
                    continue
                yield record

    def _load_record_cache(self):
        """Parse the whole file once into start-sorted per-contig lists
        (unindexed fallback: O(file) once, O(log n) per region)."""
        if self._records_by_contig is not None:
            return
        buckets = {}
        with _open_text(self._path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                record = self._parse_line(line)
                buckets.setdefault(record.chrom, []).append(record)
        cache = {}
        for chrom, records in buckets.items():
            records.sort(key=lambda r: r.start)
            starts = [r.start for r in records]
            span = max(r.stop - r.start for r in records)
            cache[chrom] = (records, starts, span)
        self._records_by_contig = cache

    def fetch(self, contig=None, start=None, stop=None):
        """Yield records, optionally restricted to those overlapping
        [start, stop) of ``contig`` (pysam fetch semantics)."""
        if contig is None:
            with _open_text(self._path) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    yield self._parse_line(line)
            return
        if self._records_by_contig is None and self._load_tabix() is not None:
            yield from self._fetch_tabix(contig, start, stop)
            return
        self._load_record_cache()
        records, starts, span = self._records_by_contig.get(contig, ([], [], 0))
        lo = 0 if start is None else bisect.bisect_left(starts, start - span)
        hi = len(records) if stop is None else bisect.bisect_left(starts, stop)
        for record in records[lo:hi]:
            if start is not None and record.stop <= start:
                continue
            if stop is not None and record.start >= stop:
                continue
            yield record

    def __iter__(self):
        return self.fetch()

    def close(self):
        self._records_by_contig = None
        if self._bgzf is not None:
            self._bgzf.close()
            self._bgzf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _split_meta(body):
    """Split a ##META=<...> body on commas outside double quotes."""
    parts = []
    current = []
    in_quotes = False
    for char in body:
        if char == '"':
            in_quotes = not in_quotes
            current.append(char)
        elif char == "," and not in_quotes:
            parts.append("".join(current))
            current = []
        else:
            current.append(char)
    if current:
        parts.append("".join(current))
    return parts
