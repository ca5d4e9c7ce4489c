"""Character-array sequence helpers (host-side numpy).

Covers the reference's ``mchap/encoding/character/`` package.
"""

import numpy as np


def as_allelic(array, alleles=None, dtype=np.int8):
    """Allele characters -> integers given per-position allele tuples.

    Unrecognised symbols encode as gaps (-1).
    Reference: encoding/character/transcode.py:4-50.
    """
    array = np.asarray(array)
    shape = array.shape
    if array.ndim == 1:
        symbols = array.reshape(1, shape[-1] if shape else 0)
    else:
        n_seq = int(np.prod(shape[:-1]))
        symbols = array.reshape(n_seq, shape[-1])
    n_seq, n_pos = symbols.shape
    out = np.full((n_seq, n_pos), -1, dtype=dtype)
    if alleles is None:
        uniq = np.unique(symbols)
        lut = {s: int(s) for s in uniq if str(s).isdigit()}
        for s, a in lut.items():
            out[symbols == s] = a
    else:
        for j, tup in enumerate(alleles):
            col = symbols[:, j]
            for a, char in enumerate(tup):
                out[col == char, j] = a
    return out.reshape(shape)


def is_gap(array, gap="-"):
    """Gap mask over character arrays; reference character/sequence.py:4-22."""
    return np.asarray(array) == gap


def depth(array, gap="-"):
    """Per-position depth of non-gap characters; character/sequence.py:25-43."""
    return np.sum(~is_gap(array, gap=gap), axis=-2)
