"""VCF genotype-index combinadics and counting functions (numpy).

Port of ``mchap_tpu/numerics/combinadics.py``, limited to what the
assemble and call paths use.  Genotype tables are small and built once
on the host, so exact int64 numpy arithmetic replaces the JAX versions.
"""

from functools import lru_cache
import itertools
import math

import numpy as np


def _comb_with_replacement(n, k: int):
    """Multiset coefficient C(n + k - 1, k) for int64 arrays ``n``, static
    ``k``; reference jitutils.py:228-250."""
    n = np.asarray(n, np.int64)
    m = n + k - 1
    r = np.ones_like(m)
    for d in range(1, k + 1):
        r = r * (m - k + d) // d
    r = np.where(m < k, 0, r)
    return np.where((n == 0) & (k == 0), 0, r)


def genotype_alleles_as_index(alleles):
    """VCF genotype-order index of a genotype of ascending allele numbers.

    index = sum_i C(a_i + i, i + 1) over allele slots i (VCF spec "genotype
    ordering"); reference ``jitutils.py:253-276``.  ``alleles`` may carry
    leading batch dimensions; the final axis is the ploidy.
    """
    alleles = np.asarray(alleles, np.int64)
    ploidy = alleles.shape[-1]
    index = np.zeros(alleles.shape[:-1], np.int64)
    for i in range(ploidy):
        index = index + _comb_with_replacement(alleles[..., i], i + 1)
    return index


@lru_cache(maxsize=None)
def _genotype_table_cached(n_alleles: int, ploidy: int):
    tuples = np.array(
        list(itertools.combinations_with_replacement(range(n_alleles), ploidy)),
        dtype=np.int32,
    ).reshape(-1, ploidy)
    order = np.argsort(genotype_alleles_as_index(tuples), kind="stable")
    table = tuples[order]
    table.setflags(write=False)
    return table


def enumerate_genotypes(n_alleles: int, ploidy: int) -> np.ndarray:
    """All C(n_alleles + ploidy - 1, ploidy) genotypes in VCF order.

    Rows are ascending allele tuples; row g has combinadic index g.
    """
    return _genotype_table_cached(n_alleles, ploidy)


def index_as_genotype_alleles_np(index: int, ploidy: int) -> np.ndarray:
    """Inverse of ``genotype_alleles_as_index`` for one index.

    Reference: ``jitutils.py:279-318``.  A negative index gives all -1.
    """
    out = np.full(ploidy, -2, np.int64)
    if index < 0:
        out[:] = -1
        return out
    remainder = int(index)
    for slot in range(ploidy):
        p = ploidy - slot
        n = -1
        new = 0
        prev = 0
        while new <= remainder:
            n += 1
            prev = new
            new = math.comb(n + p - 1, p) if n > 0 else 0
        n -= 1
        remainder -= prev
        out[p - 1] = n
    return out


def count_unique_haplotypes(u_alleles) -> int:
    """Product of per-position allele counts; reference combinatorics.py:16-32."""
    return int(np.prod(np.asarray(u_alleles, dtype=np.int64)))


def count_unique_genotypes(u_haps: int, ploidy: int) -> int:
    """Multiset coefficient; reference combinatorics.py:35-54."""
    return math.comb(u_haps + ploidy - 1, ploidy)


def count_genotype_permutations(dosage) -> int:
    """Multinomial coefficient of a dosage; reference combinatorics.py:101-127."""
    dosage = np.asarray(dosage)
    denominator = 1
    for d in dosage:
        denominator *= math.factorial(int(d))
    return math.factorial(int(dosage.sum())) // denominator
