"""``io.read_extract.ms_per_locus``: the self time of the program's
``io.read_extract`` spans (less the decode nested in them): each (locus,
sample)'s reads fetched and their alleles read at the SNVs
(`io/bam.py`), in ms per locus.

Layer: host IO and encoding.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``io.read_extract`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "io.read_extract", less="children")
