"""``device.idle_pct``: the share of the traced window in which the card
runs no kernel, copy or memset.

Layer: the device.  From the profiler's timeline (``trace.py``): one
minus the union of the device activities' intervals over the window.
Moves ``loci_per_s``: what the device idles, the host holds it back.
"""

UNIT = "%"


def read(ctx):
    if ctx.get("window_s") is None or ctx.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
