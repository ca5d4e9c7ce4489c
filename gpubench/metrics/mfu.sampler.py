"""``mfu.sampler``: the window's sampler work as a share of what the card
could do in the window, in %.

Layer: the whole job.  The least time on the card of all the sampling
work that the window's jobs need (``k1_roofline``'s count for
``assemble``, ``k2_roofline``'s for ``call``, whichever route runs it),
over the traced window's length.  It bounds every kernel's gain: a
change that takes a kernel off the path leaves that kernel's roofline
silent, and this share still counts the work.  Moves ``loci_per_s``.
"""

import importlib.util
import pathlib

from gpubench.metrics._work import least_seconds

UNIT = "%"
COUNTS = {"assemble": "k1_roofline", "call": "k2_roofline"}


def _counter(name):
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(ctx):
    name = COUNTS.get(ctx["cell"]["tool"])
    if name is None or not ctx.get("window_s"):
        return None
    least = least_seconds(_counter(name).window_work(ctx), ctx["card"])
    if least is None:
        return None
    return 100.0 * least / ctx["window_s"]
