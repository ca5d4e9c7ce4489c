"""``pedigree.prep.ms_per_locus``: the program's ``pedigree.prep``
spans: ``call-pedigree``'s host work in the sampler stage before the
launch (``models/pedigree._fit``: the read-haplotype matrices, the greedy
start, K3's plan), in ms per locus.

Layer: sampler stage.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``pedigree.prep`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "pedigree.prep")
