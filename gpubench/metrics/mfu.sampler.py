"""``mfu.sampler``: the window's sampler work as a share of what the card
could do in the window, in %.

Layer: the whole job.  The least time on the card of all the sampling
work that the window's jobs need (counted by the per-layer metric that
the tool file names as its ``WORK``: ``k1_roofline`` for ``assemble``,
``k2_roofline`` for ``call``, whichever route runs it), over the traced
window's length.  It bounds every kernel's gain: a change that takes a
kernel off the path leaves that kernel's roofline silent, and this share
still counts the work.  Moves ``loci_per_s``.
"""

from gpubench import run
from gpubench.metrics._work import least_seconds

UNIT = "%"


def read(ctx):
    if not ctx.get("window_s"):
        return None
    work = run.load_metric(run.load_tool(ctx["cell"]["tool"]).WORK).window_work(ctx)
    least = least_seconds(work, ctx["card"])
    if least is None:
        return None
    return 100.0 * least / ctx["window_s"]
