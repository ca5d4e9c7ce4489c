"""Self-contained BAM/SAM reader (no htslib dependency).

The reference delegates alignment IO to pysam/htslib; this build ships
its own reader so the framework is fully standalone.  BGZF blocks are
plain concatenated gzip members, which Python's zlib/gzip handles
natively; records follow the BAM binary layout from the SAM spec.

API shape mirrors the pysam subset used by the reference
(``mchap/io/bam.py``): ``AlignmentFile(path).header['RG']``,
``fetch(contig, start, stop)`` yielding reads with flag accessors and
``get_aligned_pairs(matches_only=True, with_seq=True)`` (reference
sequence reconstructed from the MD tag when present).

Region fetch is index-driven when a ``.bai``/``.csi`` sits next to the
BAM (the reference's htslib pattern, ``mchap/io/bam.py:128``): only the
BGZF blocks whose chunks can overlap the region are decompressed, so
per-locus cost is proportional to the region, not the file.  Without an
index the reader falls back to decoding and position-indexing each
contig once per handle, with binary-searched region lookups.
"""

import gzip
import struct

import numpy as np

from mchap_tpu_torch.io import indexing

_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"

# flag bits (SAM spec)
FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


class AlignedRead:
    """One alignment record (BAM or SAM source)."""

    __slots__ = (
        "qname",
        "flag",
        "reference_name",
        "pos",
        "mapping_quality",
        "cigar",
        "seq",
        "quals",
        "tags",
    )

    def __init__(self, qname, flag, reference_name, pos, mapq, cigar, seq, quals, tags):
        self.qname = qname
        self.flag = flag
        self.reference_name = reference_name
        self.pos = pos  # 0-based leftmost
        self.mapping_quality = mapq
        self.cigar = cigar  # list of (op_char, length)
        self.seq = seq
        self.quals = quals  # int array (phred)
        self.tags = tags

    @property
    def is_unmapped(self):
        return bool(self.flag & FUNMAP)

    @property
    def is_duplicate(self):
        return bool(self.flag & FDUP)

    @property
    def is_qcfail(self):
        return bool(self.flag & FQCFAIL)

    @property
    def is_supplementary(self):
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def reference_end(self):
        end = self.pos
        for op, ln in self.cigar:
            if op in "MDN=X":
                end += ln
        return end

    def get_tag(self, tag):
        return self.tags[tag]

    def has_tag(self, tag):
        return tag in self.tags

    def get_aligned_pairs(self, matches_only=False, with_seq=False):
        """(read_pos, ref_pos[, ref_char]) tuples for aligned bases.

        With ``with_seq``, reference characters are reconstructed from
        the MD tag (lowercase at mismatches, as in pysam); without an MD
        tag the read's own base is reported for matches and None cannot
        be distinguished — callers that validate reference alleles
        should prefer reads with MD or validate against the FASTA.
        """
        ref_seq = self._reference_sequence() if with_seq else None
        pairs = []
        read_i = 0
        ref_i = self.pos
        md_i = 0  # index into reconstructed reference (aligned ref bases)
        for op, ln in self.cigar:
            if op in "M=X":
                for k in range(ln):
                    if with_seq:
                        char = ref_seq[md_i] if ref_seq is not None else self.seq[read_i]
                        pairs.append((read_i, ref_i, char))
                    else:
                        pairs.append((read_i, ref_i))
                    read_i += 1
                    ref_i += 1
                    md_i += 1
            elif op in "IS":
                if not matches_only:
                    for k in range(ln):
                        pairs.append((read_i, None, None) if with_seq else (read_i, None))
                        read_i += 1
                else:
                    read_i += ln
            elif op in "DN":
                if not matches_only:
                    for k in range(ln):
                        pairs.append((None, ref_i, None) if with_seq else (None, ref_i))
                        ref_i += 1
                else:
                    ref_i += ln
                if op == "D":
                    pass  # MD deletions handled in _reference_sequence
            # H, P consume nothing
        return pairs

    def _reference_sequence(self):
        """Aligned-reference bases (M/=/X columns only) from the MD tag."""
        md = self.tags.get("MD")
        if md is None:
            # no MD: assume read matches reference at aligned columns
            out = []
            read_i = 0
            for op, ln in self.cigar:
                if op in "M=X":
                    out.append(self.seq[read_i : read_i + ln])
                    read_i += ln
                elif op in "IS":
                    read_i += ln
            return "".join(out)
        # reconstruct: numbers = matching run, letters = ref base at
        # mismatch (reported lowercase), ^XYZ = deleted ref bases (skip)
        aligned_read = []
        read_i = 0
        for op, ln in self.cigar:
            if op in "M=X":
                aligned_read.append(self.seq[read_i : read_i + ln])
                read_i += ln
            elif op in "IS":
                read_i += ln
        aligned_read = "".join(aligned_read)
        out = []
        i = 0  # position in MD walk over aligned columns
        j = 0  # position in md string
        while j < len(md):
            c = md[j]
            if c.isdigit():
                k = j
                while j < len(md) and md[j].isdigit():
                    j += 1
                run = int(md[k:j])
                out.append(aligned_read[i : i + run])
                i += run
            elif c == "^":
                j += 1
                while j < len(md) and md[j].isalpha():
                    j += 1  # deleted ref bases: not aligned columns
            else:
                out.append(c.lower())
                i += 1
                j += 1
        return "".join(out)


def _parse_sam_header_text(text):
    header = {"RG": []}
    references = []
    for line in text.splitlines():
        if line.startswith("@RG"):
            fields = dict(
                f.split(":", 1) for f in line.strip().split("\t")[1:] if ":" in f
            )
            header["RG"].append(fields)
        elif line.startswith("@SQ"):
            fields = dict(
                f.split(":", 1) for f in line.strip().split("\t")[1:] if ":" in f
            )
            references.append((fields.get("SN"), int(fields.get("LN", 0))))
    return header, references


def _decode_bam_records(data, refs):
    """Yield AlignedRead from concatenated uncompressed BAM record bytes."""
    offset = 0
    n = len(data)
    unpack_from = struct.unpack_from
    while offset < n:
        (block_size,) = unpack_from("<i", data, offset)
        base = offset + 4
        (
            ref_id,
            pos,
            l_read_name,
            mapq,
            _bin,
            n_cigar,
            flag,
            l_seq,
            _next_ref,
            _next_pos,
            _tlen,
        ) = unpack_from("<iiBBHHHiiii", data, base)
        p = base + 32
        qname = data[p : p + l_read_name - 1].decode()
        p += l_read_name
        cigar = []
        for _ in range(n_cigar):
            (v,) = unpack_from("<I", data, p)
            cigar.append((_CIGAR_OPS[v & 0xF], v >> 4))
            p += 4
        nbytes = (l_seq + 1) // 2
        seq_bytes = data[p : p + nbytes]
        p += nbytes
        seq_chars = []
        for b in seq_bytes:
            seq_chars.append(_SEQ_CODES[b >> 4])
            seq_chars.append(_SEQ_CODES[b & 0xF])
        seq = "".join(seq_chars[:l_seq])
        quals = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=p).astype(
            np.int16
        )
        p += l_seq
        end = base + block_size
        tags = _parse_aux(data, p, end)
        refname = refs[ref_id][0] if 0 <= ref_id < len(refs) else None
        yield AlignedRead(qname, flag, refname, pos, mapq, cigar, seq, quals, tags)
        offset = end


def _parse_aux(data, p, end):
    tags = {}
    unpack_from = struct.unpack_from
    while p < end:
        tag = data[p : p + 2].decode()
        typ = chr(data[p + 2])
        p += 3
        if typ == "A":
            tags[tag] = chr(data[p])
            p += 1
        elif typ in "cC":
            tags[tag] = data[p] if typ == "C" else unpack_from("<b", data, p)[0]
            p += 1
        elif typ in "sS":
            tags[tag] = unpack_from("<h" if typ == "s" else "<H", data, p)[0]
            p += 2
        elif typ in "iI":
            tags[tag] = unpack_from("<i" if typ == "i" else "<I", data, p)[0]
            p += 4
        elif typ == "f":
            tags[tag] = unpack_from("<f", data, p)[0]
            p += 4
        elif typ in "ZH":
            q = data.index(b"\x00", p)
            tags[tag] = data[p:q].decode()
            p = q + 1
        elif typ == "B":
            sub = chr(data[p])
            (count,) = unpack_from("<i", data, p + 1)
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            fmt = "<" + str(count) + sub.lower() if sub != "f" else "<" + str(count) + "f"
            # use numpy for array tags
            dt = {"c": np.int8, "C": np.uint8, "s": np.int16, "S": np.uint16,
                  "i": np.int32, "I": np.uint32, "f": np.float32}[sub]
            tags[tag] = np.frombuffer(data, dtype=dt, count=count, offset=p + 5)
            p += 5 + size * count
        else:
            raise ValueError(f"unsupported BAM aux type {typ!r}")
    return tags


def _parse_sam_line(line, default_qual=0):
    fields = line.rstrip("\n").split("\t")
    qname = fields[0]
    flag = int(fields[1])
    rname = fields[2] if fields[2] != "*" else None
    pos = int(fields[3]) - 1
    mapq = int(fields[4])
    cigar = []
    num = ""
    for c in fields[5]:
        if c.isdigit():
            num += c
        else:
            cigar.append((c, int(num)))
            num = ""
    seq = fields[9] if fields[9] != "*" else ""
    if fields[10] != "*":
        quals = np.frombuffer(fields[10].encode(), np.uint8).astype(np.int16) - 33
    else:
        quals = np.full(len(seq), default_qual, np.int16)
    tags = {}
    for f in fields[11:]:
        tag, typ, val = f.split(":", 2)
        if typ == "i":
            val = int(val)
        elif typ == "f":
            val = float(val)
        tags[tag] = val
    return AlignedRead(qname, flag, rname, pos, mapq, cigar, seq, quals, tags)


def _native_header_text(lib, handle):
    import ctypes

    return ctypes.cast(lib.bam_header_text(handle), ctypes.c_char_p).value.decode()


def _wrap_native_records(lib, handle, refs):
    """Wrap a native decoder handle's columnar arrays into AlignedRead
    buckets keyed by contig (shared by the BAM and CRAM loaders)."""
    import ctypes

    n = lib.bam_n_records(handle)
    if n == 0:
        return {}

    def ints(fn, count):
        return np.ctypeslib.as_array(fn(handle), shape=(count,)).copy()

    refid = ints(lib.bam_refid, n)
    pos = ints(lib.bam_pos, n)
    mapq = ints(lib.bam_mapq, n)
    flag = ints(lib.bam_flag, n)
    qname_off = np.ctypeslib.as_array(
        lib.bam_qname_off(handle), shape=(n + 1,)
    ).copy()
    cigar_off = np.ctypeslib.as_array(
        lib.bam_cigar_off(handle), shape=(n + 1,)
    ).copy()
    seq_off = np.ctypeslib.as_array(lib.bam_seq_off(handle), shape=(n + 1,)).copy()
    aux_off = np.ctypeslib.as_array(lib.bam_aux_off(handle), shape=(n + 1,)).copy()
    qname_blob = ctypes.string_at(lib.bam_qname_blob(handle), int(qname_off[-1]))
    seq_blob = ctypes.string_at(lib.bam_seq_blob(handle), int(seq_off[-1]))
    qual_blob = np.frombuffer(
        ctypes.string_at(lib.bam_qual_blob(handle), int(seq_off[-1])),
        dtype=np.uint8,
    ).astype(np.int16)
    aux_blob = ctypes.string_at(lib.bam_aux_blob(handle), int(aux_off[-1]))
    cigar_blob = np.ctypeslib.as_array(
        lib.bam_cigar_blob(handle), shape=(int(cigar_off[-1]),)
    ).copy()

    lens = cigar_blob >> 4
    ops = cigar_blob & 0xF
    buckets = {}
    for i in range(n):
        qname = qname_blob[qname_off[i] : qname_off[i + 1]].decode()
        cigar = [
            (_CIGAR_OPS[ops[c]], int(lens[c]))
            for c in range(cigar_off[i], cigar_off[i + 1])
        ]
        seq = seq_blob[seq_off[i] : seq_off[i + 1]].decode()
        quals = qual_blob[seq_off[i] : seq_off[i + 1]]
        tags = _parse_aux(aux_blob, int(aux_off[i]), int(aux_off[i + 1]))
        rid = refid[i]
        refname = refs[rid][0] if 0 <= rid < len(refs) else None
        read = AlignedRead(
            qname, int(flag[i]), refname, int(pos[i]), int(mapq[i]),
            cigar, seq, quals, tags,
        )
        buckets.setdefault(refname, []).append(read)
    for reads in buckets.values():
        reads.sort(key=lambda r: r.pos)
    return buckets


class AlignmentFile:
    """BAM, CRAM or SAM reader with pysam-like surface.

    CRAM decoding runs through the native C++ decoder
    (native/cramreader.cpp); mapped CRAM records need the reference
    FASTA, passed as ``reference_filename`` (same convention as pysam,
    reference io/bam.py:41).
    """

    def __init__(self, path, reference_filename=None):
        self.filename = str(path).encode()
        self._path = str(path)
        self._reference_filename = reference_filename
        self._records_by_contig = None
        self._pos_index = {}  # contig -> (pos array, max read span)
        self._region_index = None  # lazily-loaded .bai/.csi
        self._region_index_tried = False
        self._bgzf = None
        with open(self._path, "rb") as f:
            magic = f.read(4)
        if magic[:2] == b"\x1f\x8b":
            self._format = "BAM"
        elif magic == b"CRAM":
            self._format = "CRAM"
        else:
            self._format = "SAM"
        self._load_header()

    def _cram_lib(self):
        from mchap_tpu_torch.native import load_library

        lib = load_library()
        if lib is None:
            raise RuntimeError(
                "CRAM decoding requires the native decoder "
                "(g++ toolchain unavailable)"
            )
        return lib

    def _load_cram(self, header_only=False):
        """Decode the CRAM through the native library.

        ``header_only`` reads just the SAM header container (container
        headers are walked, data containers skipped) so opening a CRAM
        costs O(header), mirroring the BAM/.bai pattern; a later region
        fetch decodes only overlapping containers."""
        lib = self._cram_lib()
        ref = self._reference_filename
        if header_only:
            handle = lib.cram_load_region(
                self._path.encode(), (str(ref) if ref else "").encode(),
                b"", 0, 0,
            )
        else:
            handle = lib.cram_load(
                self._path.encode(), (str(ref) if ref else "").encode()
            )
        if not handle:
            raise ValueError(
                f"CRAM decode failed for {self._path}: "
                f"{lib.bam_error().decode()}"
            )
        try:
            text = _native_header_text(lib, handle)
            self._header_text = text
            header, sam_refs = _parse_sam_header_text(text)
            self.header = header
            self._refs = sam_refs
            if not header_only:
                self._records_by_contig = _wrap_native_records(
                    lib, handle, self._refs
                )
        finally:
            lib.bam_free(handle)

    def _fetch_cram_region(self, contig, start, stop):
        """Decode only the CRAM containers overlapping the region (the
        same per-container coordinate filter a .crai index provides)."""
        lib = self._cram_lib()
        ref = self._reference_filename
        beg = 0 if start is None else max(0, int(start))
        end = (1 << 62) if stop is None else int(stop)
        handle = lib.cram_load_region(
            self._path.encode(), (str(ref) if ref else "").encode(),
            contig.encode(), beg, end,
        )
        if not handle:
            raise ValueError(
                f"CRAM region decode failed for {self._path}: "
                f"{lib.bam_error().decode()}"
            )
        try:
            buckets = _wrap_native_records(lib, handle, self._refs)
        finally:
            lib.bam_free(handle)
        for read in buckets.get(contig, []):
            if start is not None and read.reference_end <= start:
                continue
            if stop is not None and read.pos >= stop:
                continue
            yield read

    def _load_header(self):
        if self._format == "CRAM":
            self._load_cram(header_only=True)
            return
        if self._format == "BAM":
            with gzip.open(self._path, "rb") as f:
                magic = f.read(4)
                if magic != b"BAM\x01":
                    raise ValueError(f"not a BAM file: {self._path}")
                (l_text,) = struct.unpack("<i", f.read(4))
                text = f.read(l_text).rstrip(b"\x00").decode()
                (n_ref,) = struct.unpack("<i", f.read(4))
                refs = []
                for _ in range(n_ref):
                    (l_name,) = struct.unpack("<i", f.read(4))
                    name = f.read(l_name)[:-1].decode()
                    (l_ref,) = struct.unpack("<i", f.read(4))
                    refs.append((name, l_ref))
                self._header_text = text
                self._refs = refs
                self._records_start = None  # records parsed on demand
            header, sam_refs = _parse_sam_header_text(text)
            self.header = header
            if not refs and sam_refs:
                self._refs = sam_refs
        else:
            with open(self._path) as f:
                header_lines = []
                first_record = None
                for line in f:
                    if line.startswith("@"):
                        header_lines.append(line)
                    else:
                        first_record = line
                        break
            if not header_lines and (
                first_record is None or len(first_record.split("\t")) < 11
            ):
                # neither a SAM header nor a SAM alignment line: reject so
                # callers can distinguish alignment files from text lists
                raise ValueError(f"not a SAM/BAM file: {self._path}")
            text = "".join(header_lines)
            self._header_text = text
            header, refs = _parse_sam_header_text(text)
            self.header = header
            self._refs = refs

    def _load_records(self):
        if self._records_by_contig is not None:
            return
        if self._format == "CRAM":
            self._load_cram()
            return
        if self._format == "BAM" and self._load_records_native():
            return
        buckets = {}
        if self._format == "BAM":
            with gzip.open(self._path, "rb") as f:
                f.read(4)
                (l_text,) = struct.unpack("<i", f.read(4))
                f.read(l_text)
                (n_ref,) = struct.unpack("<i", f.read(4))
                for _ in range(n_ref):
                    (l_name,) = struct.unpack("<i", f.read(4))
                    f.read(l_name + 4)
                data = f.read()
            for read in _decode_bam_records(data, self._refs):
                buckets.setdefault(read.reference_name, []).append(read)
        else:
            with open(self._path) as f:
                for line in f:
                    if line.startswith("@") or not line.strip():
                        continue
                    read = _parse_sam_line(line)
                    buckets.setdefault(read.reference_name, []).append(read)
        for reads in buckets.values():
            reads.sort(key=lambda r: r.pos)
        self._records_by_contig = buckets

    def _load_records_native(self):
        """Decode records with the native C++ BGZF/BAM library.

        Returns True on success; False falls back to the pure-Python
        decoder (no toolchain, or decode error).
        """
        try:
            from mchap_tpu_torch.native import load_library
        except Exception:
            return False
        lib = load_library()
        if lib is None:
            return False
        handle = lib.bam_load(self._path.encode())
        if not handle:
            return False
        try:
            self._records_by_contig = _wrap_native_records(
                lib, handle, self._refs
            )
        finally:
            lib.bam_free(handle)
        return True

    def _load_region_index(self):
        """Lazily read the on-disk .bai/.csi (BAM only)."""
        if self._region_index_tried:
            return self._region_index
        self._region_index_tried = True
        if self._format != "BAM":
            return None
        kind, idx_path = indexing.find_index(self._path)
        try:
            if kind == "bai":
                self._region_index = indexing.read_bai(idx_path)
            elif kind == "csi":
                self._region_index = indexing.read_csi(idx_path)
        except (OSError, ValueError):
            self._region_index = None  # unreadable index: full-decode path
        return self._region_index

    def _fetch_indexed(self, contig, start, stop):
        """Decode only the BGZF chunks whose records can overlap
        [start, stop) (SAM-spec binning; parity with htslib fetch)."""
        index = self._region_index
        ref_id = next(
            (i for i, (name, _) in enumerate(self._refs) if name == contig), -1
        )
        beg = 0 if start is None else max(0, int(start))
        end = (1 << 29) if stop is None else int(stop)
        if self._bgzf is None:
            self._bgzf = indexing.BGZFFile(self._path)
        for vbeg, vend in index.chunks(ref_id, beg, end):
            data = self._bgzf.stream(vbeg, vend)
            for read in _decode_bam_records(data, self._refs):
                if read.reference_name != contig:
                    continue
                if start is not None and read.reference_end <= start:
                    continue
                if stop is not None and read.pos >= stop:
                    continue
                yield read

    def _bucket_range(self, contig, start, stop):
        """Slice of a contig bucket that can overlap [start, stop),
        found by binary search (pos sorted; start bound widened by the
        bucket's maximum reference span)."""
        bucket = self._records_by_contig.get(contig, [])
        if not bucket or (start is None and stop is None):
            return bucket
        cached = self._pos_index.get(contig)
        if cached is None:
            pos = np.fromiter((r.pos for r in bucket), np.int64, count=len(bucket))
            span = max(r.reference_end - r.pos for r in bucket)
            cached = (pos, span)
            self._pos_index[contig] = cached
        pos, span = cached
        lo = 0 if start is None else int(np.searchsorted(pos, start - span, "left"))
        hi = len(bucket) if stop is None else int(np.searchsorted(pos, stop, "left"))
        return bucket[lo:hi]

    def fetch(self, contig=None, start=None, stop=None):
        """Yield mapped reads overlapping [start, stop) of ``contig``."""
        if contig is None:
            self._load_records()
            for bucket in self._records_by_contig.values():
                yield from bucket
            return
        if self._records_by_contig is None and self._format == "CRAM":
            yield from self._fetch_cram_region(contig, start, stop)
            return
        if self._records_by_contig is None and self._load_region_index() is not None:
            yield from self._fetch_indexed(contig, start, stop)
            return
        self._load_records()
        for read in self._bucket_range(contig, start, stop):
            if start is not None and read.reference_end <= start:
                continue
            if stop is not None and read.pos >= stop:
                continue
            yield read

    def close(self):
        self._records_by_contig = None
        self._pos_index = {}
        if self._bgzf is not None:
            self._bgzf.close()
            self._bgzf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
