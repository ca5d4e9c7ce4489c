"""Allele filter strings "<field><op><value>" over INFO fields.

Reference: mchap/io/filter_alleles.py.  Operates on vcflite records
(which carry their header's Number declarations).
"""

import re

import numpy as np

_COMPARATOR = {
    "=": np.equal,
    "==": np.equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "<": np.less,
    "<=": np.less_equal,
    "!=": np.not_equal,
}


def parse_allele_filter(string):
    """Parse "<field><operator><value>"; reference filter_alleles.py:16-52."""
    pattern = r"^(\w+)(=|>|<|==|!=|>=|<|<=|<>)(\d*[.,]?\d*)$"
    match = re.search(pattern, string)
    if not match:
        raise ValueError(f"Invalid allele filter '{string}'")
    field = match.group(1)
    operator = match.group(2)
    if operator not in _COMPARATOR:
        raise ValueError(f"Invalid operator in allele filter '{operator}'")
    func = _COMPARATOR[operator]
    value = match.group(3)
    try:
        value = int(value)
    except ValueError:
        try:
            value = float(value)
        except ValueError:
            raise ValueError(f"Non-numerical value in allele filter '{value}'")
    return field, func, value


def apply_allele_filter(record, field, func, value):
    """Boolean keep-mask over R alleles; reference filter_alleles.py:55-96."""
    length = record.info_number(field)
    if length is None:
        raise ValueError(f"Allele filter field not found in header '{field}'")
    if length not in {"R", "A"}:
        raise ValueError(f"Allele filter of field of invalid length '{length}'")
    n_alts = len(record.alts) if record.alts else 0
    observations = record.info.get(field)
    if observations is None:
        keep = np.ones(1 + n_alts, dtype=bool)
    elif length == "R":
        assert len(observations) == 1 + n_alts
        keep = func(np.asarray(observations, float), value)
    else:  # "A"
        assert len(observations) == n_alts
        keep = np.ones(1 + n_alts, dtype=bool)
        keep[1:] = func(np.asarray(observations, float), value)
    return keep
