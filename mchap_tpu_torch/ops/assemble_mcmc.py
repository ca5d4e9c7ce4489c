"""Per-position homozygosity screen of the de novo assembler.

Port of the flat-prior screen of ``mchap_tpu/ops/assemble_mcmc.py``
(reference assemble/mcmc.py:168-199): before sampling, each SNV's
genotype posterior is computed on its own, and positions whose
homozygous genotype reaches ``--mcmc-fix-homozygous`` are fixed.  The
screen is host numpy (a few BLAS calls per block).  The
Dirichlet-multinomial prior screen and the XLA sampler of that module
are not ported yet (ROADMAP queue 4, item 3).
"""

import numpy as np

from mchap_tpu_torch.numerics.combinadics import (
    enumerate_genotypes,
    genotype_alleles_as_index,
)
from mchap_tpu_torch.ops.exact import genotype_dosage_table


def _hom_batch_probs_np(reads_b, n_alleles_mat, read_counts_b, ploidy):
    """Flat-prior per-position genotype posteriors [S, nb, G]: f32 dosage
    product + per-read log, f64 read-axis reduction and normalisation."""
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
    valid = np.all(
        table[None, None, :, :] < np.asarray(n_alleles_mat)[:, :, None, None],
        axis=-1,
    )  # [S, nb, G]
    logits = np.where(valid, llks, -np.inf)
    mx = logits.max(axis=-1, keepdims=True)
    e = np.exp(logits - mx)
    return e / e.sum(axis=-1, keepdims=True)


def homozygosity_probabilities_batch(reads_b, n_alleles_mat, ploidy,
                                     read_counts_b=None):
    """Probability that each position is homozygous for each allele.

    reads_b: f[S, R, nb, A] (padded; zero-count reads weigh nothing),
    n_alleles_mat: i[S, nb], read_counts_b: f[S, R].  Returns f[S, nb, A].
    """
    n_samples, n_reads, nb, max_allele = reads_b.shape
    if read_counts_b is None:
        read_counts_b = np.ones((n_samples, max(n_reads, 1)))
    if n_reads == 0:
        reads_b = np.full((n_samples, 1, nb, max_allele), np.nan)
        read_counts_b = np.ones((n_samples, 1))
    probs = _hom_batch_probs_np(reads_b, n_alleles_mat, read_counts_b, ploidy)
    hom_idx = genotype_alleles_as_index(
        np.repeat(np.arange(max_allele)[:, None], ploidy, axis=1)
    )
    return probs[:, :, hom_idx]  # [S, nb, A]
