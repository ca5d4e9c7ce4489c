"""``pedigree.posterior.ms_per_locus``: the program's ``pedigree.posterior``
spans: each locus's per-sample summaries of the joint trace
(``call-pedigree``'s ``_finish_samples``: each sample's trace,
posterior mode, MCI and fields), in ms per locus.

Layer: posterior and VCF.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``pedigree.posterior`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "pedigree.posterior")
