"""``posterior.samples.ms_per_locus``: the program's ``posterior.samples``
spans: each locus's posteriors and per-sample fields (`models/*`
posterior and tabulation, ``host.posterior_tab`` included), in ms per
locus.

Layer: posterior and VCF.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``posterior.samples`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "posterior.samples")
