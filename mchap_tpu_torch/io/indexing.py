"""BGZF random access and htslib-style region indexes (BAI/CSI/TBI).

The reference reaches reads and variants through htslib *indexes*
(pysam fetch, reference ``mchap/io/bam.py:128``; tabix regions at
``mchap/io/loci.py:337-361``), so per-locus IO cost is proportional to
the region, not the file.  This module gives the standalone readers the
same property without htslib:

- :class:`BGZFFile` — random access into a BGZF file (BAM, bgzip VCF):
  decompress exactly the blocks covering a virtual-offset range, with
  an LRU block cache so sequential loci re-use decompressed blocks.
- :func:`read_bai` / :func:`read_csi` / :func:`read_tbi` — parse the
  three htslib index formats into a common :class:`RegionIndex`.
- :func:`RegionIndex.chunks` — the R-tree bin walk (reg2bins) plus
  linear-index filtering and chunk merging, yielding the minimal set of
  virtual-offset ranges whose records can overlap a region.

Virtual offsets are the htslib convention: ``coffset << 16 | uoffset``
(compressed block start, offset into the decompressed block).
"""

import gzip
import struct
import zlib
from collections import OrderedDict

_BGZF_EOF = (
    b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43"
    b"\x02\x00\x1b\x00\x03\x00\x00\x00\x00\x00\x00\x00\x00\x00"
)

# pseudo-bin holding per-reference metadata rather than chunks
_PSEUDO_BIN = 37450


def is_bgzf(path):
    """True if the file starts with a BGZF block header (gzip + BC)."""
    with open(path, "rb") as f:
        head = f.read(18)
    if len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04":
        return False
    (xlen,) = struct.unpack_from("<H", head, 10)
    with open(path, "rb") as f:
        f.seek(12)
        extra = f.read(xlen)
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return True
        i += 4 + slen
    return False


class BGZFFile:
    """Random-access reader over a BGZF-compressed file.

    ``stream(vbeg, vend)`` returns the decompressed bytes between two
    virtual offsets, touching only the blocks in that range.  Blocks are
    cached (LRU, ``cache_blocks`` entries of <=64KiB each) so a batch of
    nearby loci decompresses each block once.  ``n_block_decodes``
    counts physical decompressions — tests use it to assert that region
    fetches do region-sized work.
    """

    def __init__(self, path, cache_blocks=256):
        self._f = open(path, "rb")
        self._cache = OrderedDict()  # coffset -> (data, next_coffset)
        self._cache_blocks = cache_blocks
        self.n_block_decodes = 0

    def close(self):
        self._f.close()
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def block(self, coffset):
        """Decompressed content of the block starting at ``coffset`` and
        the compressed offset of the next block."""
        hit = self._cache.get(coffset)
        if hit is not None:
            self._cache.move_to_end(coffset)
            return hit
        f = self._f
        f.seek(coffset)
        head = f.read(18)
        if len(head) < 18:
            raise EOFError(f"BGZF block at {coffset}: truncated header")
        if head[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"BGZF block at {coffset}: bad magic")
        (xlen,) = struct.unpack_from("<H", head, 10)
        f.seek(coffset + 12)
        extra = f.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = (
                extra[i],
                extra[i + 1],
                struct.unpack_from("<H", extra, i + 2)[0],
            )
            if si1 == 66 and si2 == 67 and slen == 2:
                (bsize,) = struct.unpack_from("<H", extra, i + 4)
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError(f"BGZF block at {coffset}: no BC subfield")
        f.seek(coffset)
        raw = f.read(bsize + 1)
        data = zlib.decompress(raw, 15 + 32)
        self.n_block_decodes += 1
        entry = (data, coffset + bsize + 1)
        self._cache[coffset] = entry
        if len(self._cache) > self._cache_blocks:
            self._cache.popitem(last=False)
        return entry

    def stream(self, vbeg, vend):
        """Decompressed bytes in the virtual-offset range [vbeg, vend)."""
        cbeg, ubeg = vbeg >> 16, vbeg & 0xFFFF
        cend, uend = vend >> 16, vend & 0xFFFF
        parts = []
        coffset = cbeg
        while coffset <= cend:
            if coffset == cend and uend == 0:
                break
            data, nxt = self.block(coffset)
            lo = ubeg if coffset == cbeg else 0
            hi = uend if coffset == cend else len(data)
            parts.append(data[lo:hi])
            if coffset == cend:
                break
            coffset = nxt
        return b"".join(parts)


def reg2bins(beg, end, min_shift=14, depth=5):
    """Bin numbers that may hold records overlapping [beg, end).

    The standard UCSC/htslib binning walk (SAM spec section 5.3;
    reference behavior via pysam/htslib ``reg2bins``).
    """
    if end <= beg:
        end = beg + 1
    end -= 1
    bins = [0]
    base = 0
    for level in range(1, depth + 1):
        base += 1 << (3 * (level - 1))
        shift = min_shift + 3 * (depth - level)
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


def reg2bin(beg, end, min_shift=14, depth=5):
    """The smallest bin fully containing [beg, end) (SAM spec 5.3)."""
    if end <= beg:
        end = beg + 1
    end -= 1
    base = 0
    for level in range(depth, 0, -1):
        shift = min_shift + 3 * (depth - level)
        if beg >> shift == end >> shift:
            # cumulative offset of this level's first bin
            offset = ((1 << (3 * level)) - 1) // 7
            return offset + (beg >> shift)
    return 0


class RegionIndex:
    """One reference sequence's worth of index: bins -> chunk lists plus
    (BAI/TBI) a 16kb-window linear index of minimum virtual offsets."""

    def __init__(self, min_shift=14, depth=5):
        self.min_shift = min_shift
        self.depth = depth
        # list per reference: ({bin: [(vbeg, vend), ...]}, [ioffset, ...])
        self.refs = []

    def chunks(self, ref_id, start, stop):
        """Merged virtual-offset chunks that may hold records
        overlapping [start, stop) of reference ``ref_id``."""
        if ref_id < 0 or ref_id >= len(self.refs):
            return []
        bins, linear = self.refs[ref_id]
        min_off = 0
        if linear:
            window = start >> self.min_shift
            if window < len(linear):
                min_off = linear[window]
            elif linear:
                min_off = linear[-1]
        out = []
        for b in reg2bins(start, stop, self.min_shift, self.depth):
            for vbeg, vend in bins.get(b, ()):
                if vend > min_off:
                    out.append((max(vbeg, min_off), vend))
        out.sort()
        merged = []
        for vbeg, vend in out:
            if merged and vbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], vend))
            else:
                merged.append((vbeg, vend))
        return merged


def _read_binning(buf, offset, n_ref, with_loffset=False):
    """Shared bin/chunk walk for BAI and TBI (and CSI with loffset)."""
    index = RegionIndex()
    unpack_from = struct.unpack_from
    p = offset
    for _ in range(n_ref):
        (n_bin,) = unpack_from("<i", buf, p)
        p += 4
        bins = {}
        for _ in range(n_bin):
            (bin_id,) = unpack_from("<I", buf, p)
            p += 4
            if with_loffset:
                p += 8  # loffset: unused (we fall back to full bin walk)
            (n_chunk,) = unpack_from("<i", buf, p)
            p += 4
            chunks = []
            for _ in range(n_chunk):
                vbeg, vend = unpack_from("<QQ", buf, p)
                p += 16
                chunks.append((vbeg, vend))
            if bin_id != _PSEUDO_BIN:
                bins[bin_id] = chunks
        linear = []
        if not with_loffset:
            (n_intv,) = unpack_from("<i", buf, p)
            p += 4
            linear = list(unpack_from("<%dQ" % n_intv, buf, p))
            p += 8 * n_intv
        index.refs.append((bins, linear))
    return index, p


def read_bai(path):
    """Parse a .bai index (plain binary, SAM spec section 5.2)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"BAI\x01":
        raise ValueError(f"not a BAI index: {path}")
    (n_ref,) = struct.unpack_from("<i", buf, 4)
    index, _ = _read_binning(buf, 8, n_ref)
    return index


def read_csi(path):
    """Parse a .csi index (BGZF-compressed, CSIv1 spec)."""
    with gzip.open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"CSI\x01":
        raise ValueError(f"not a CSI index: {path}")
    min_shift, depth, l_aux = struct.unpack_from("<iii", buf, 4)
    (n_ref,) = struct.unpack_from("<i", buf, 16 + l_aux)
    index, _ = _read_binning(buf, 20 + l_aux, n_ref, with_loffset=True)
    index.min_shift = min_shift
    index.depth = depth
    return index


class TabixIndex:
    """A .tbi index: a RegionIndex plus contig-name mapping and the
    coordinate-column metadata tabix stores (tabix spec)."""

    def __init__(self, index, names, fmt, col_seq, col_beg, col_end, meta_char, skip):
        self.index = index
        self.names = names
        self.name_to_id = {n: i for i, n in enumerate(names)}
        self.format = fmt
        self.col_seq = col_seq
        self.col_beg = col_beg
        self.col_end = col_end
        self.meta_char = meta_char
        self.skip = skip

    def chunks(self, contig, start, stop):
        ref_id = self.name_to_id.get(contig)
        if ref_id is None:
            return []
        return self.index.chunks(ref_id, start, stop)


def read_tbi(path):
    """Parse a .tbi tabix index (BGZF-compressed, tabix spec)."""
    with gzip.open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"TBI\x01":
        raise ValueError(f"not a tabix index: {path}")
    n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm = struct.unpack_from(
        "<8i", buf, 4
    )
    names = bytes(buf[36 : 36 + l_nm]).split(b"\x00")[:n_ref]
    names = [n.decode() for n in names]
    index, _ = _read_binning(buf, 36 + l_nm, n_ref)
    return TabixIndex(index, names, fmt, col_seq, col_beg, col_end, chr(meta), skip)


def find_index(path):
    """Locate the on-disk index for an alignment/variant file.

    Returns (kind, index_path) where kind is 'bai', 'csi' or 'tbi', or
    (None, None) when no index exists (callers fall back to whole-file
    decoding, which remains correct, just not region-proportional).
    """
    import os

    path = str(path)
    for kind, suffix in (("bai", ".bai"), ("csi", ".csi"), ("tbi", ".tbi")):
        cand = path + suffix
        if os.path.exists(cand):
            return kind, cand
    return None, None
