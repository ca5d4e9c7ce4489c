"""``summarize_format.ms_per_locus``: the program's ``summarize_format`` stage in ms per locus.

Layer: posterior and VCF (`models/*` posterior and tabulation, `io/vcf.py`).  Read from the program's stage timer (a host clock around
synchronous host code) in the traced run.  Moves ``loci_per_s``.
"""

from gpubench.metrics._stage import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "summarize_format")
