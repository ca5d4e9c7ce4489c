"""BED4 target-interval reading; reference io/loci.py:316-361."""

import gzip

from mchap_tpu_torch.io.loci import Locus


def _parse_bed4_line(line):
    fields = line.split()
    return Locus(
        contig=fields[0].strip(),
        start=int(fields[1]),
        stop=int(fields[2]),
        name=fields[3].strip() if len(fields) > 3 else None,
        sequence=None,
        variants=None,
    )


def _parse_region(region):
    """'contig' or 'contig:start-stop' -> (contig, start, stop)."""
    if ":" not in region:
        return region, None, None
    contig, interval = region.split(":")
    start, stop = interval.split("-")
    return contig, int(start), int(stop)


def read_bed4(bed, region=None):
    """Yield Locus records from a BED4 file (plain or gzipped).

    ``region`` restricts to intervals overlapping "contig[:start-stop]"
    (the reference requires tabix for this; here the gzipped text is
    scanned directly — equivalent output, no index requirement).
    """
    if region and not isinstance(region, str):
        # pysam-style tuple (contig[, start[, stop]])
        parts = list(region)
        contig = parts[0]
        start = parts[1] if len(parts) > 1 else None
        stop = parts[2] if len(parts) > 2 else None
    elif region:
        contig, start, stop = _parse_region(region)
    else:
        contig = start = stop = None

    with open(bed, "rb") as raw:
        token = raw.read(3)
        raw.seek(0)
        handle = gzip.GzipFile(fileobj=raw) if token[:2] == b"\x1f\x8b" else raw
        for line in handle:
            line = line.decode() if isinstance(line, bytes) else line
            if line.startswith("#") or not line.strip():
                continue
            locus = _parse_bed4_line(line)
            if contig is not None:
                if locus.contig != contig:
                    continue
                if start is not None and locus.stop <= start:
                    continue
                if stop is not None and locus.start >= stop:
                    continue
            yield locus
