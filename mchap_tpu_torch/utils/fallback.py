"""Tally of which implementation each dispatch site ran.

``note_path(site, path)`` records a path; the timing summary
(``utils.timing``) prints the tally, e.g. ``paths: denovo=cuda x12``.
The port has no fallback: a kernel that fails to build or launch
raises, so this module only counts.
"""

from collections import Counter

#: tally of (site, path) -> count for the timing summary
PATHS = Counter()


def note_path(site, path):
    """Record that dispatch site ``site`` executed implementation ``path``."""
    PATHS[(site, path)] += 1


def summary_lines():
    """Path tally lines for the timing summary (empty when nothing ran)."""
    if not PATHS:
        return []
    parts = [
        f"{site}={path} x{count}"
        for (site, path), count in sorted(PATHS.items())
    ]
    return ["paths: " + ", ".join(parts)]
