"""``device_sampler.ms_per_locus``: the program's ``device_sampler`` stage in ms per locus.

Layer: the sampler stage (`models/{assemble,calling}.py` fits, `parallel/sharding.py`, `ops/*`), up to the moment the traces reach the host.  Read from the program's stage timer (a host clock around
synchronous host code) in the traced run.  Moves ``loci_per_s``.
"""

from gpubench.metrics._stage import ms_per_locus

UNIT = "ms/locus"


def read(ctx):
    return ms_per_locus(ctx, "device_sampler")
