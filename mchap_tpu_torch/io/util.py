"""Phred <-> probability conversions (reference mchap/io/util.py)."""

import numpy as np


def qual_of_char(char):
    """Phred char(s) -> integer qual(s); reference io/util.py:12-37."""
    if isinstance(char, str):
        return ord(char) - 33
    char = np.asarray(char)
    if char.dtype != np.dtype("<U1"):
        raise ValueError('Array must have dtype "<U1"')
    return char.view(np.int32).reshape(char.shape) - 33


def prob_of_qual(qual):
    """Phred qual -> probability call is correct; reference io/util.py:40-53."""
    return 1 - (10 ** (np.asarray(qual) / -10))


def qual_of_prob(prob, precision=6):
    """Probability -> phred qual, capped by decimal precision (max qual 60
    at precision 6); reference io/util.py:56-88."""
    maximum = 1 - 0.1**precision
    prob = np.minimum(np.asarray(prob, dtype=float), maximum)
    prob = np.floor(prob * 10**precision) / 10**precision
    quals = np.round(-10 * np.log10(1 - prob)).astype(int)
    if np.shape(quals) == ():
        return int(quals)
    return quals
