"""``encoding.reads.ms_per_locus``: the program's ``encoding.reads`` spans:
each (locus, sample)'s probabilistic encoding and read de-duplication
(`io/bam.py`, `application/baseclass.py`), in ms per locus.

Layer: host IO and encoding.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``encoding.reads`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "encoding.reads")
