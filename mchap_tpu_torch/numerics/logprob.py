"""Log-space helpers used by the assemble path."""

import math


def natural_log_to_log10(x):
    """Reference: jitutils.py:174-177."""
    return x * math.log10(math.e)
