"""Dosage bookkeeping over allele-index genotypes (PyTorch, batched).

Port of ``mchap_tpu/numerics/dosage.py`` (reference
``mchap/calling/utils.py`` and ``mchap/jitutils.py:149-171,350-422``).
Every function takes leading batch dimensions; the final axis is the
ploidy.
"""

import torch


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _first_occurrence(eq):
    """Slots that hold the first copy of their value.  eq [..., p, p]."""
    ploidy = eq.shape[-1]
    tri = torch.tril(
        torch.ones((ploidy, ploidy), dtype=torch.bool, device=eq.device), diagonal=-1
    )
    return ~torch.any(eq & tri, dim=-1)


def allelic_dosage(genotype_alleles):
    """Dosage of each allele slot, credited to the first occurrence.

    ``dosage[i] = count of genotype[i] in genotype`` if slot ``i`` is the
    first slot holding that allele, else 0.  Reference:
    ``calling/utils.py:7-35``.
    """
    g = _as_tensor(genotype_alleles)
    eq = g[..., :, None] == g[..., None, :]
    counts = eq.sum(dim=-1)
    return torch.where(_first_occurrence(eq), counts, 0).to(g.dtype)


def count_allele(genotype_alleles, allele):
    """Count occurrences of ``allele`` in a genotype; calling/utils.py:38-57."""
    g = _as_tensor(genotype_alleles)
    allele = torch.as_tensor(allele, device=g.device)
    return (g == allele[..., None]).sum(dim=-1)


def ln_equivalent_permutations(dosage):
    """Log multinomial coefficient ploidy! / prod(dosage_i!) (f64).

    Reference: ``jitutils.py:149-171``.  Zero entries contribute
    lgamma(1) = 0.
    """
    d = _as_tensor(dosage).to(torch.float64)
    ploidy = d.sum(dim=-1)
    return torch.lgamma(ploidy + 1) - torch.lgamma(d + 1).sum(dim=-1)


def haplotype_dosage(genotype):
    """Dosage of each haplotype row in a genotype of haplotype vectors.

    ``genotype``: int[..., ploidy, n_pos].  Reference
    ``get_haplotype_dosage`` (jitutils.py:378-422): dosage credited to
    the first of each group of equal rows, 0 for duplicates.
    """
    g = _as_tensor(genotype)
    eq = torch.all(g[..., :, None, :] == g[..., None, :, :], dim=-1)
    counts = eq.sum(dim=-1)
    return torch.where(_first_occurrence(eq), counts, 0).to(torch.int32)
