"""``pedigree.incongruence.ms_per_locus``: the program's ``pedigree.incongruence``
spans: each locus's PEDERR pass over the joint trace
(``models/pedigree.PedigreeAllelesMultiTrace.incongruence``), in ms per locus.

Layer: posterior and VCF.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``pedigree.incongruence`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "pedigree.incongruence")
