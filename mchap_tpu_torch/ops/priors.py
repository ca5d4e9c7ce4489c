"""Genotype priors (flat and Dirichlet-multinomial), batched PyTorch f64.

Port of ``mchap_tpu/ops/priors.py``, which re-implements the prior math
of the reference:
- assemble-side dosage priors: ``mchap/assemble/prior.py:15-112``
- calling-side allele priors with optional frequencies:
  ``mchap/calling/prior.py:10-179``

Every function takes leading batch dimensions.  ``inbreeding`` may be a
number or a tensor that broadcasts against the genotype's batch shape;
``frequencies`` is [..., H] and its leading dimensions broadcast the
same way.  ``inbreeding == 0`` selects the flat branch elementwise.
"""

import math

import torch

from mchap_tpu_torch.numerics.dosage import (
    allelic_dosage,
    count_allele,
    ln_equivalent_permutations,
)

_F64 = torch.float64


def _f64(x, device=None):
    return torch.as_tensor(x, dtype=_F64, device=device)


def _take(values, index):
    """values[..., index] with ``values`` [..., H] broadcast to index's
    batch shape: -> index.shape."""
    values = values.expand(index.shape[:-1] + values.shape[-1:])
    return torch.gather(values, -1, index.long())


def calculate_alphas(inbreeding, frequencies):
    """Dirichlet-multinomial dispersion alphas; calling/prior.py:10-27."""
    return frequencies * ((1.0 - inbreeding) / inbreeding)


def log_genotype_null_prior(dosage, log_unique_haplotypes):
    """Flat prior: permutations / u_haps^ploidy; assemble/prior.py:15-36."""
    d = _f64(dosage)
    ploidy = d.sum(dim=-1)
    return ln_equivalent_permutations(d) - ploidy * log_unique_haplotypes


def log_dirichlet_multinomial_pmf(dosage, log_dispersion, log_unique_haplotypes):
    """Equal-alpha Dirichlet-multinomial pmf; assemble/prior.py:39-78."""
    d = _f64(dosage)
    log_dispersion = _f64(log_dispersion, d.device)
    ploidy = d.sum(dim=-1)
    dispersion = torch.exp(log_dispersion)
    sum_dispersion = torch.exp(log_dispersion + log_unique_haplotypes)
    left = (
        torch.lgamma(ploidy + 1.0) + torch.lgamma(sum_dispersion)
        - torch.lgamma(ploidy + sum_dispersion)
    )
    # per-dose terms; dose == 0 contributes exactly 0
    disp = dispersion[..., None]
    num = torch.lgamma(d + disp)
    denom = torch.lgamma(d + 1.0) + torch.lgamma(disp.expand_as(d))
    prod = torch.where(d > 0, num - denom, 0.0).sum(dim=-1)
    return left + prod


def log_genotype_prior_dosage(dosage, log_unique_haplotypes, inbreeding=0.0):
    """Assemble-model genotype prior over a haplotype dosage.

    Reference ``assemble/prior.py:81-112``; flat when inbreeding == 0 else
    Dirichlet-multinomial with alpha = (1/u_haps) * (1-F)/F.
    """
    d = _f64(dosage)
    inbreeding = _f64(inbreeding, d.device)
    flat = log_genotype_null_prior(d, log_unique_haplotypes)
    safe_f = torch.where(inbreeding > 0, inbreeding, 0.5)
    log_dispersion = torch.log((1.0 - safe_f) / safe_f) - log_unique_haplotypes
    dirmul = log_dirichlet_multinomial_pmf(d, log_dispersion, log_unique_haplotypes)
    return torch.where(inbreeding == 0.0, flat, dirmul)


def log_genotype_prior(genotype, unique_haplotypes, inbreeding=0.0, frequencies=None):
    """Calling-model genotype prior over allele-index genotypes.

    Reference ``calling/prior.py:116-179``.  ``genotype``: int[...,
    ploidy] indices into a panel of ``unique_haplotypes`` alleles.
    """
    g = torch.as_tensor(genotype)
    ploidy = g.shape[-1]
    inbreeding = _f64(inbreeding, g.device)
    dosage = allelic_dosage(g)
    ln_perms = ln_equivalent_permutations(dosage)

    # --- non-inbred branch ---
    if frequencies is None:
        flat = ln_perms - ploidy * math.log(unique_haplotypes)
    else:
        freqs = _f64(frequencies, g.device)
        flat = ln_perms + torch.log(torch.prod(_take(freqs, g), dim=-1))

    # --- Dirichlet-multinomial branch ---
    safe_f = torch.where(inbreeding > 0, inbreeding, 0.5)
    if frequencies is None:
        alpha_const = calculate_alphas(safe_f, 1.0 / unique_haplotypes)
        sum_alphas = alpha_const * unique_haplotypes
        alphas_g = alpha_const[..., None].expand(g.shape)
    else:
        alphas = calculate_alphas(safe_f[..., None], freqs)
        sum_alphas = alphas.sum(dim=-1)
        alphas_g = _take(alphas, g)
    d = dosage.to(_F64)
    left = (
        math.lgamma(ploidy + 1.0) + torch.lgamma(sum_alphas)
        - torch.lgamma(ploidy + sum_alphas)
    )
    num = torch.lgamma(d + alphas_g)
    denom = torch.lgamma(d + 1.0) + torch.lgamma(alphas_g)
    prod = torch.where(d > 0, num - denom, 0.0).sum(dim=-1)
    dirmul = left + prod

    return torch.where(inbreeding == 0.0, flat, dirmul)


def log_genotype_allele_flat_prior(genotype, variable_allele):
    """Gibbs conditional flat prior: log(count of the variable allele).

    Reference ``calling/prior.py:30-52``.  ``variable_allele`` is the
    slot index, one per genotype of the batch.
    """
    g = torch.as_tensor(genotype)
    slot = torch.as_tensor(variable_allele, device=g.device)
    a = torch.gather(g, -1, slot.expand(g.shape[:-1])[..., None].long())
    n = (g == a).sum(dim=-1)
    return torch.log(n.to(_F64))


def log_genotype_allele_prior(
    genotype, variable_allele, unique_haplotypes, inbreeding=0.0, frequencies=None
):
    """Gibbs conditional prior of one allele slot given the rest.

    Reference ``calling/prior.py:55-113``.
    """
    g = torch.as_tensor(genotype)
    ploidy = g.shape[-1]
    inbreeding = _f64(inbreeding, g.device)
    slot = torch.as_tensor(variable_allele, device=g.device)
    a = torch.gather(g, -1, slot.expand(g.shape[:-1])[..., None].long())[..., 0]

    # --- non-inbred branch ---
    if frequencies is None:
        flat = torch.full(
            g.shape[:-1], math.log(1.0 / unique_haplotypes), dtype=_F64,
            device=g.device,
        )
    else:
        freqs = _f64(frequencies, g.device)
        flat = torch.log(_take(freqs, a[..., None])[..., 0])

    # --- Dirichlet-multinomial branch ---
    constant_sum = ploidy - 1
    constant_ibs = count_allele(g, a) - 1
    safe_f = torch.where(inbreeding > 0, inbreeding, 0.5)
    if frequencies is None:
        alpha = calculate_alphas(safe_f, 1.0 / unique_haplotypes)
        sum_alpha = constant_sum + alpha * unique_haplotypes
        variable_alpha = alpha + constant_ibs
    else:
        alphas = calculate_alphas(safe_f[..., None], freqs)
        sum_alpha = constant_sum + alphas.sum(dim=-1)
        variable_alpha = _take(alphas, a[..., None])[..., 0] + constant_ibs
    left = torch.lgamma(sum_alpha) - torch.lgamma(1.0 + sum_alpha)
    right = torch.lgamma(1.0 + variable_alpha) - torch.lgamma(variable_alpha)
    dirmul = left + right

    return torch.where(inbreeding == 0.0, flat, dirmul)
