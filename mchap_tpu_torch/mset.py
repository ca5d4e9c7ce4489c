"""Multiset algebra over arrays-of-rows (host-side numpy).

API parity with reference ``mchap/mset.py`` (dict/Counter based there);
here rows are compared via lexicographic sorting / structured views so
every operation is vectorized.  Used for read de-duplication, kmer
tabulation, and posterior-allele labeling; device-side posterior
tabulation uses genotype indices instead (see models/*).
"""

import numpy as np


def _as2d(array):
    array = np.ascontiguousarray(array)
    assert array.ndim == 2
    return array


def _keys(array):
    """Row-wise void keys enabling O(n log n) row set operations."""
    array = _as2d(array)
    if array.shape[1] == 0:
        return np.zeros(len(array), dtype="V1")
    return array.view([("", array.dtype)] * array.shape[1]).ravel()


def unique_idx(array):
    """Index of first occurrence of each unique row, in first-seen order.

    Reference: mset.py:242-262.
    """
    keys = _keys(array)
    _, idx = np.unique(keys, return_index=True)
    return np.sort(idx)


def unique(array):
    """Unique rows in first-seen order; reference mset.py:265-284."""
    return _as2d(array)[unique_idx(array)]


def unique_counts(array):
    """Unique rows (first-seen order) + their multiplicities.

    Reference: mset.py:361-392 — the read-dedup primitive
    (application/baseclass.py:207-209).
    """
    array = _as2d(array)
    keys = _keys(array)
    uniq, idx, counts = np.unique(keys, return_index=True, return_counts=True)
    order = np.argsort(idx, kind="stable")
    return array[idx[order]], counts[order]


def count(array, elements):
    """Count how many times each row of ``elements`` occurs in ``array``.

    Reference: mset.py:324-358.
    """
    array = _as2d(array)
    elements = _as2d(elements)
    akeys = _keys(array)
    ekeys = _keys(elements)
    uniq, counts = np.unique(akeys, return_counts=True)
    pos = np.searchsorted(uniq, ekeys)
    pos = np.clip(pos, 0, max(len(uniq) - 1, 0))
    if len(uniq) == 0:
        return np.zeros(len(elements), dtype=int)
    hit = uniq[pos] == ekeys
    return np.where(hit, counts[pos], 0)


def contains(array, elements):
    """Bool per row of ``elements``: occurs in ``array``; mset.py:186-212."""
    return count(array, elements) > 0


def within(elements, array):
    """Bool per row of ``elements``: occurs in ``array``; mset.py:215-239."""
    return contains(array, elements)


def equal(x, y):
    """Multiset equality of two row arrays; reference mset.py:157-183."""
    x, y = _as2d(x), _as2d(y)
    if x.shape != y.shape:
        return False
    return bool(np.array_equal(np.sort(_keys(x)), np.sort(_keys(y))))


def add(x, y):
    """Multiset sum (concatenation); reference mset.py:7-30."""
    return np.concatenate([_as2d(x), _as2d(y)], axis=0)


def subtract(x, y):
    """Multiset difference x - y; reference mset.py:33-71."""
    x, y = _as2d(x), _as2d(y)
    xkeys, ykeys = _keys(x), _keys(y)
    uniq, ycounts = np.unique(ykeys, return_counts=True)
    remaining = dict(zip(uniq.tolist(), ycounts.tolist()))
    keep = np.ones(len(x), dtype=bool)
    for i, key in enumerate(xkeys.tolist()):
        n = remaining.get(key, 0)
        if n > 0:
            keep[i] = False
            remaining[key] = n - 1
    return x[keep]


def intercept(x, y):
    """Multiset intersection (min counts); reference mset.py:74-112."""
    x = _as2d(x)
    ux, ucx = unique_counts(x)
    ucy = count(_as2d(y), ux)
    take = np.minimum(ucx, ucy)
    return np.repeat(ux, take, axis=0)


def union(x, y):
    """Multiset union (max counts); reference mset.py:115-154."""
    x, y = _as2d(x), _as2d(y)
    rows = unique(np.concatenate([x, y], axis=0))
    nx = count(x, rows)
    ny = count(y, rows)
    return np.repeat(rows, np.maximum(nx, ny), axis=0)


def categorize(elements, categories):
    """Index of each row of ``elements`` within unique ``categories`` rows.

    Rows not present in ``categories`` get -1.  Reference: mset.py:287-321.
    """
    elements = _as2d(elements)
    categories = _as2d(categories)
    ckeys = _keys(categories)
    ekeys = _keys(elements)
    order = np.argsort(ckeys, kind="stable")
    sorted_keys = ckeys[order]
    pos = np.searchsorted(sorted_keys, ekeys)
    pos = np.clip(pos, 0, max(len(ckeys) - 1, 0))
    if len(ckeys) == 0:
        return np.full(len(elements), -1, dtype=int)
    hit = sorted_keys[pos] == ekeys
    return np.where(hit, order[pos], -1)


def repeat(array, counts):
    """Repeat each row by its count; reference mset.py:395-418."""
    return np.repeat(_as2d(array), counts, axis=0)
