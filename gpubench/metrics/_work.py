"""Shared by the roofline and mfu readers: a count of work's least time
on the card, from ``peaks.json``."""

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def least_seconds(work, card):
    """The larger of the operations over their peak rates and the bytes
    over the memory's, for the card named ``card`` (None if the table
    has no such card).  ``work``: flops, transcendentals, bytes."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    ops = max(work["flops"] / peak["f32_flop_per_s"],
              work["transcendentals"] / peak["transcendental_per_s"])
    return max(ops, work["bytes"] / peak["hbm_byte_per_s"])


def add(a, b):
    return {k: a.get(k, 0.0) + b.get(k, 0.0) for k in ("flops", "transcendentals", "bytes")}
