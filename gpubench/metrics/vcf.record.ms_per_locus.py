"""``vcf.record.ms_per_locus``: the program's ``vcf.record`` spans: each
locus's INFO reductions and VCF record (`application/baseclass.py`,
`io/vcf.py`), in ms per locus.

Layer: posterior and VCF.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``vcf.record`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "vcf.record")
