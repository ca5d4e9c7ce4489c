"""Minimal indexed FASTA reader (replaces pysam.FastaFile usage)."""


class FastaFile:
    """Random-access FASTA using the .fai index when present."""

    def __init__(self, path):
        self._path = str(path)
        self._index = {}
        self._order = []
        try:
            with open(self._path + ".fai") as f:
                for line in f:
                    name, length, offset, linebases, linewidth = line.split()[:5]
                    self._index[name] = (
                        int(length),
                        int(offset),
                        int(linebases),
                        int(linewidth),
                    )
                    self._order.append(name)
            self._handle = open(self._path, "rb")
            self._seqs = None
        except FileNotFoundError:
            # no index: load everything
            self._handle = None
            self._seqs = {}
            name = None
            chunks = []
            with open(self._path) as f:
                for line in f:
                    line = line.strip()
                    if line.startswith(">"):
                        if name is not None:
                            self._seqs[name] = "".join(chunks)
                        name = line[1:].split()[0]
                        self._order.append(name)
                        chunks = []
                    else:
                        chunks.append(line)
            if name is not None:
                self._seqs[name] = "".join(chunks)
            self._index = {n: (len(s), 0, 0, 0) for n, s in self._seqs.items()}

    @property
    def references(self):
        return list(self._order)

    @property
    def lengths(self):
        return [self._index[n][0] for n in self._order]

    def get_reference_length(self, name):
        return self._index[name][0]

    def fetch(self, contig, start=None, stop=None):
        length = self._index[contig][0]
        start = 0 if start is None else max(0, start)
        stop = length if stop is None else min(length, stop)
        if self._seqs is not None:
            return self._seqs[contig][start:stop]
        _, offset, linebases, linewidth = self._index[contig]
        first = offset + (start // linebases) * linewidth + start % linebases
        last = offset + ((stop - 1) // linebases) * linewidth + (stop - 1) % linebases
        self._handle.seek(first)
        raw = self._handle.read(last - first + 1)
        return raw.decode().replace("\n", "").replace("\r", "")

    def close(self):
        if self._handle:
            self._handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
