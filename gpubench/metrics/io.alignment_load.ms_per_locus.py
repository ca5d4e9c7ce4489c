"""``io.alignment_load.ms_per_locus``: the program's ``io.alignment_load``
spans: alignment files decoded whole (`io/bamlite.py`), once per file
and job, in ms per locus.

Layer: host IO and encoding.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``io.alignment_load`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "io.alignment_load")
