"""Shared by the span readers: a program span's time per locus, from the
spans each window job keeps (``jobs.run_job``: (name, start ns, end ns)
around each of the program's spans, nested ones included, with
``MCHAP_TIMING=1``).  A span's parent is the innermost other span of its
job that contains it."""


def parents(spans):
    """Each span's parent's index in ``spans`` (None for a root)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    parent, open_ = [None] * len(spans), []
    for i in order:
        while open_ and spans[open_[-1]][2] < spans[i][2]:
            open_.pop()
        parent[i] = open_[-1] if open_ else None
        open_.append(i)
    return parent


def ms_per_locus(ctx, name, less=None):
    """Milliseconds of the window's ``name`` spans per locus.  ``less``:
    None, their whole time; ``"children"``, their self time (less the
    spans directly inside them); another name, less the spans of that
    name anywhere inside them.  None where no job has a ``name`` span,
    or, for another name, no span of that name (a program that does not
    split the span so)."""
    jobs = [j for j in ctx["jobs"] if j["ok"]]
    loci = sum(j["loci"] for j in jobs)
    if less not in (None, "children") and not any(
            sp[0] == less for job in jobs for sp in job["spans"]):
        return None
    total_ns, found = 0, False
    for job in jobs:
        spans = job["spans"]
        cut = [0] * len(spans)
        if less is not None:
            parent = parents(spans)
            for i, (span_name, start, end) in enumerate(spans):
                up = parent[i]
                if less != "children":
                    if span_name != less:
                        continue
                    while up is not None and spans[up][0] != name:
                        up = parent[up]
                if up is not None:
                    cut[up] += end - start
        for i, (span_name, start, end) in enumerate(spans):
            if span_name == name:
                found = True
                total_ns += end - start - cut[i]
    if not loci or not found:
        return None
    return total_ns / 1e6 / loci
