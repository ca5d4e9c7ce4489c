"""Gamete and cross genotype distributions (library-only utilities).

Covers reference ``mchap/assemble/inheritence.py`` (module name kept
verbatim for API parity): derive gamete distributions from a genotype
posterior and cross two gamete distributions into offspring genotype
probabilities.
"""

from collections import Counter
from itertools import combinations

import numpy as np

from mchap_tpu_torch.encoding import integer


def gamete_probabilities(genotypes, probabilities, order=None):
    """Unique gametes + probabilities from a genotype distribution.

    Reference: inheritence.py:10-75.
    """
    assert order in {None, "ascending", "descending"}
    n_gens, ploidy, n_base = genotypes.shape

    string_to_hap = {}
    genotype_strings = np.empty(n_gens * ploidy, dtype="<O")
    for i, hap in enumerate(genotypes.reshape(n_gens * ploidy, n_base)):
        string = hap.tobytes()
        string_to_hap[string] = hap
        genotype_strings[i] = string
    genotype_strings = np.sort(genotype_strings.reshape(n_gens, ploidy), axis=-1)

    gamete_probs = {}
    for genotype_string, set_prob in zip(genotype_strings, probabilities):
        gametes = list(combinations(genotype_string, ploidy // 2))
        n_gametes = len(gametes)
        for gamete, count in Counter(gametes).items():
            prob = set_prob * (count / n_gametes)
            gamete_probs[gamete] = gamete_probs.get(gamete, 0.0) + prob

    n_gametes = len(gamete_probs)
    new = np.empty((n_gametes, ploidy // 2, n_base), dtype=np.int8)
    new_probs = np.empty(n_gametes, dtype=float)
    for i, (strings, prob) in enumerate(gamete_probs.items()):
        new_probs[i] = prob
        for j, string in enumerate(strings):
            new[i, j] = string_to_hap[string]

    if order:
        idx = np.argsort(new_probs)
        if order == "descending":
            idx = np.flip(idx, axis=0)
        return new[idx], new_probs[idx]
    return new, new_probs


def cross_probabilities(
    maternal_gametes,
    maternal_probabilities,
    paternal_gametes,
    paternal_probabilities,
    order=None,
):
    """Offspring genotype distribution from two gamete distributions.

    Reference: inheritence.py:78-158.
    """
    assert order in {None, "ascending", "descending"}
    half_ploidy, n_base = maternal_gametes.shape[-2:]
    ploidy = half_ploidy * 2

    genotype_probs = {}
    string_to_genotype = {}
    for m_gamete, m_prob in zip(maternal_gametes, maternal_probabilities):
        for p_gamete, p_prob in zip(paternal_gametes, paternal_probabilities):
            genotype = np.concatenate([m_gamete, p_gamete]).astype(np.int8)
            genotype = integer.sort(genotype)
            string = genotype.tobytes()
            string_to_genotype.setdefault(string, genotype)
            genotype_probs[string] = genotype_probs.get(string, 0.0) + m_prob * p_prob

    n_genotypes = len(genotype_probs)
    new = np.empty((n_genotypes, ploidy, n_base), dtype=np.int8)
    new_probs = np.empty(n_genotypes, dtype=float)
    for i, (string, prob) in enumerate(genotype_probs.items()):
        new_probs[i] = prob
        new[i] = string_to_genotype[string]

    if order:
        idx = np.argsort(new_probs)
        if order == "descending":
            idx = np.flip(idx, axis=0)
        return new[idx], new_probs[idx]
    return new, new_probs
