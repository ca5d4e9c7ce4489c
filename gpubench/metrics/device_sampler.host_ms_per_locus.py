"""``device_sampler.host_ms_per_locus``: the program's ``device_sampler``
spans less the ``device.sync`` spans inside them (the waits for the
sampler's launches), in ms per locus.  The small waits inside the fits'
fetches still count: ``device.tabulate`` waits for the tabulation's sort
and scan (``int(n_uniq.max())``) and ``device.trace_fetch`` for its
copies to the host.

Layer: sampler stage.  Read from the spans of the traced run's jobs
(``_span.py``); None where the program opens no ``device_sampler`` span.
Moves ``loci_per_s``.
"""

from gpubench.metrics._span import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "device_sampler", less="device.sync")
