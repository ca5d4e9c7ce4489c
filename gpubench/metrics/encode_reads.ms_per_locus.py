"""``encode_reads.ms_per_locus``: the program's ``encode_reads`` stage in ms per locus.

Layer: host IO and encoding (`io/*`, `encoding/*`): alignment reading, allele calls, the probabilistic encoding and read de-duplication.  Read from the program's stage timer (a host clock around
synchronous host code) in the traced run.  Moves ``loci_per_s``.
"""

from gpubench.metrics._stage import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "encode_reads")
