"""Per-position homozygosity screen of the de novo assembler.

Port of the screen of ``mchap_tpu/ops/assemble_mcmc.py`` (reference
assemble/mcmc.py:168-199 and snpcalling.py:14-70): before sampling, each
SNV's genotype posterior is computed on its own, and positions whose
homozygous genotype reaches ``--mcmc-fix-homozygous`` are fixed.  The
screen is host code (a few BLAS calls per block): an f32 dosage product
and per-read log, an f64 read reduction and normalisation, and with a
Dirichlet-multinomial prior the f64 ``ops/priors.log_genotype_prior`` of
each genotype for the sample's inbreeding and the position's allele
count.  The XLA sampler of that module is not ported (ROADMAP queue 1,
item 2).
"""

import numpy as np
import torch

from mchap_tpu_torch.numerics.combinadics import (
    enumerate_genotypes,
    genotype_alleles_as_index,
)
from mchap_tpu_torch.ops.exact import genotype_dosage_table
from mchap_tpu_torch.ops.priors import log_genotype_prior


def _screen_priors(table, n_alleles_mat, inbreeding_b):
    """log_genotype_prior of every genotype of ``table`` [G, P] for each
    sample's inbreeding and each position's allele count: [S, nb, G]."""
    n_alleles_mat = np.asarray(n_alleles_mat)
    S, nb = n_alleles_mat.shape
    genotypes = torch.tensor(table).expand(S, *table.shape)
    inbreeding = torch.as_tensor(np.asarray(inbreeding_b, float))[:, None]
    out = np.zeros((S, nb, len(table)))
    for n in np.unique(n_alleles_mat):
        prior = log_genotype_prior(genotypes, int(n), inbreeding=inbreeding)
        rows = np.broadcast_to(prior.numpy()[:, None, :], out.shape)
        out = np.where((n_alleles_mat == n)[:, :, None], rows, out)
    return out


def _hom_batch_probs_np(reads_b, n_alleles_mat, read_counts_b, ploidy,
                        inbreeding_b=None):
    """Per-position genotype posteriors [S, nb, G]: f32 dosage product +
    per-read log, f64 read-axis reduction and normalisation; with
    ``inbreeding_b`` [S] plus the f64 genotype prior."""
    n_samples, n_reads, nb, max_allele = reads_b.shape
    table = np.asarray(enumerate_genotypes(max_allele, ploidy))  # [G, p]
    dosage = np.asarray(
        genotype_dosage_table(max_allele, ploidy), np.float32
    )  # [G, A]
    reads = np.asarray(reads_b, np.float32)
    m = np.where(np.isnan(reads), np.float32(1.0), reads)  # [S, R, nb, A]
    probs_rjg = (
        np.einsum("srja,ga->srjg", m, dosage, optimize=True) / ploidy
    )
    read_log = np.log(np.maximum(probs_rjg, np.float32(1e-30)))
    read_log *= np.asarray(read_counts_b, np.float32)[:, :, None, None]
    llks = read_log.sum(axis=1, dtype=np.float64)  # [S, nb, G]
    if inbreeding_b is not None:
        llks = llks + _screen_priors(table, n_alleles_mat, inbreeding_b)
    valid = np.all(
        table[None, None, :, :] < np.asarray(n_alleles_mat)[:, :, None, None],
        axis=-1,
    )  # [S, nb, G]
    logits = np.where(valid, llks, -np.inf)
    mx = logits.max(axis=-1, keepdims=True)
    e = np.exp(logits - mx)
    return e / e.sum(axis=-1, keepdims=True)


def homozygosity_probabilities_batch(reads_b, n_alleles_mat, ploidy,
                                     read_counts_b=None, inbreeding_b=None):
    """Probability that each position is homozygous for each allele.

    reads_b: f[S, R, nb, A] (padded; zero-count reads weigh nothing),
    n_alleles_mat: i[S, nb], read_counts_b: f[S, R], inbreeding_b: f[S]
    for the Dirichlet-multinomial prior (None: flat).  Returns
    f[S, nb, A].
    """
    n_samples, n_reads, nb, max_allele = reads_b.shape
    if read_counts_b is None:
        read_counts_b = np.ones((n_samples, max(n_reads, 1)))
    if n_reads == 0:
        reads_b = np.full((n_samples, 1, nb, max_allele), np.nan)
        read_counts_b = np.ones((n_samples, 1))
    probs = _hom_batch_probs_np(
        reads_b, n_alleles_mat, read_counts_b, ploidy, inbreeding_b
    )
    hom_idx = genotype_alleles_as_index(
        np.repeat(np.arange(max_allele)[:, None], ploidy, axis=1)
    )
    return probs[:, :, hom_idx]  # [S, nb, A]
