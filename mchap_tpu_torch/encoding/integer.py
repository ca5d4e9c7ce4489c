"""Integer-allele encodings of reads and haplotypes (host-side numpy).

Covers the surface of the reference's ``mchap/encoding/integer/``
package (transcode.py, sequence.py, kmer.py, stats.py) with vectorized
numpy implementations.  These run on the host as part of the IO/encode
pipeline; the probabilistic arrays they produce are the device inputs of
``mchap_tpu_torch.ops.likelihood``.

Conventions: alleles are small non-negative integers; ``-1`` is a gap;
probabilistic reads are float[..., n_pos, max_allele] with nan rows for
gaps and zeroed columns for disallowed alleles
(reference encoding/integer/transcode.py:16-77).
"""

import numpy as np


# ---------------------------------------------------------------------------
# transcode (reference encoding/integer/transcode.py)
# ---------------------------------------------------------------------------


def as_probabilistic(array, n_alleles=4, p=1.0, error_factor=3, dtype=float):
    """Integer alleles -> probabilistic row vectors.

    Called allele gets probability ``p``; each non-called allele gets
    ``(1 - p) / error_factor``; gap positions (allele < 0) become nan rows;
    allele columns >= n_alleles[pos] are zeroed.
    Reference: encoding/integer/transcode.py:16-77.
    """
    array = np.asarray(array)
    n_alleles = np.asarray(n_alleles)
    error_factor = np.asarray(error_factor)
    p = np.asarray(p, dtype=dtype)

    if array.shape[-1] == 0:
        return np.empty(array.shape + (0,), dtype=dtype)

    max_allele = int(np.max(n_alleles))
    alleles = np.arange(max_allele)
    onehot = array[..., None] == alleles
    out = np.where(
        onehot,
        p[..., None] * np.ones_like(alleles, dtype=dtype),
        ((1 - p) / error_factor)[..., None] * np.ones_like(alleles, dtype=dtype),
    )
    out = np.where(array[..., None] < 0, np.nan, out)
    out = np.where(np.broadcast_to(n_alleles[..., None] <= alleles, out.shape), 0.0, out)
    return out.astype(dtype)


def from_strings(data, gaps="-", length=None, dtype=np.int8):
    """Strings of digit alleles -> integer arrays; gaps -> -1.

    Reference: encoding/integer/transcode.py:115-162.
    """
    if isinstance(data, str):
        data = np.asarray([data])
        squeeze = True
    else:
        data = np.asarray(data)
        squeeze = False
    sequences = data.ravel()
    if length is None:
        length = max((len(s) for s in sequences), default=0)
    out = np.full((len(sequences), length), -1, dtype=dtype)
    for i, s in enumerate(sequences):
        for j, char in enumerate(s[:length]):
            out[i, j] = -1 if char in gaps else int(char)
    if squeeze:
        return out[0]
    return out.reshape(data.shape + (length,))


def as_strings(array, gap="-", alleles=None):
    """Integer arrays -> strings; reference transcode.py:189-223."""
    array = np.asarray(array)
    chars = as_characters(array, gap=gap, alleles=alleles)
    if array.ndim == 1:
        return "".join(chars)
    flat = chars.reshape(-1, array.shape[-1])
    strings = np.array(["".join(row) for row in flat], dtype="U{}".format(array.shape[-1]))
    return strings.reshape(array.shape[:-1])


def as_characters(array, gap="-", alleles=None):
    """Integer arrays -> per-position character arrays.

    Reference: encoding/integer/transcode.py:256-289.
    """
    array = np.asarray(array)
    n_pos = array.shape[-1]
    if alleles is None:
        lookup = np.array([str(i) for i in range(max(int(array.max(initial=0)) + 1, 1))], dtype="U1")
        out = np.where(array >= 0, lookup[np.clip(array, 0, None)], gap)
    else:
        max_allele = max(len(tup) for tup in alleles) if n_pos else 1
        table = np.full((n_pos, max_allele), gap, dtype="U1")
        for j, tup in enumerate(alleles):
            for a, char in enumerate(tup):
                table[j, a] = char
        pos = np.arange(n_pos)
        out = np.where(
            array >= 0, table[pos, np.clip(array, 0, max_allele - 1)], gap
        )
    return out.astype("U1")


# ---------------------------------------------------------------------------
# sequence (reference encoding/integer/sequence.py)
# ---------------------------------------------------------------------------


def is_gap(array):
    """Gap (== -1) mask; reference sequence.py:15-33."""
    return np.asarray(array) == -1


def is_call(array):
    """Called (>= 0) mask; reference sequence.py:36-54."""
    return np.asarray(array) >= 0


def is_valid(array):
    """Valid (>= -1) mask; reference sequence.py:57-75."""
    return np.asarray(array) >= -1


def argsort(array):
    """Lexicographic row order; reference sequence.py:78-93."""
    array = np.asarray(array)
    assert array.ndim == 2
    return np.lexsort(np.flip(array, axis=-1).transpose((-1, -2)))


def sort(array):
    """Lexicographically sorted rows; reference sequence.py:96-110."""
    array = np.asarray(array)
    return array[argsort(array)]


def depth(array, counts=None):
    """Per-position depth of called alleles; reference sequence.py:113-135."""
    called = is_call(array)
    if counts is None:
        return np.sum(called, axis=-2)
    return np.sum(called.astype(int) * np.expand_dims(counts, -1), axis=-2)


# ---------------------------------------------------------------------------
# kmer (reference encoding/integer/kmer.py) — padded-kmer representation
# ---------------------------------------------------------------------------


def _window_kmers(array, k):
    """All complete (gap-free) kmers of rows of ``array`` padded to n_base.

    Returns (kmers int[n_kmers, n_base], start_positions int[n_kmers]).
    Vectorized replacement for the reference's generator ``iter_kmers``
    (kmer.py:15-48); ordering is window-major per read to match.
    """
    array = np.asarray(array)
    n_base = array.shape[-1]
    reads = array.reshape(-1, n_base)
    n_windows = n_base - (k - 1)
    if n_windows <= 0 or len(reads) == 0:
        return np.empty((0, n_base), dtype=array.dtype), np.empty(0, int)
    # windows[r, w, :] = reads[r, w:w+k]
    windows = np.lib.stride_tricks.sliding_window_view(reads, k, axis=-1)
    complete = ~np.any(windows < 0, axis=-1)  # [n_reads, n_windows]
    r_idx, w_idx = np.nonzero(complete)
    kmers = np.full((len(r_idx), n_base), -1, dtype=array.dtype)
    cols = w_idx[:, None] + np.arange(k)
    rows = np.arange(len(r_idx))[:, None]
    kmers[rows, cols] = windows[r_idx, w_idx]
    return kmers, w_idx


def iter_kmers(array, k=3):
    """Yield padded kmer vectors; reference kmer.py:15-48."""
    kmers, _ = _window_kmers(array, k)
    yield from kmers


def kmer_counts(array, k=3):
    """Unique padded kmers + counts, in first-seen order.

    Reference: kmer.py:51-97.
    """
    kmers, _ = _window_kmers(array, k)
    if len(kmers) == 0:
        return np.array([], dtype=np.asarray(array).dtype), np.array([], dtype=int)
    from mchap_tpu_torch import mset

    return mset.unique_counts(kmers)


def kmer_positions(kmers, end=False):
    """Base positions of each kmer; reference kmer.py:100-128."""
    assert end in {False, "start", "stop"}
    coding = ~is_gap(kmers)
    k = np.sum(coding, axis=-1)
    assert np.all(k[0] == k)
    k = int(k[0])
    positions = np.where(coding)[1]
    if end == "start":
        return positions[0::k]
    if end == "stop":
        return positions[k - 1 :: k]
    return positions.reshape(-1, k)


def kmer_frequency(kmers, counts):
    """Frequency of each kmer among kmers starting at its position.

    Reference: kmer.py:131-163.
    """
    coding = ~is_gap(kmers)
    k = np.sum(coding, axis=-1)
    assert np.all(k[0] == k)
    k = int(k[0])
    positions = np.where(coding)[1][0::k]
    n_windows = kmers.shape[-1] - (k - 1)
    depths = np.bincount(positions, weights=counts, minlength=n_windows)
    return counts / depths[positions]


# ---------------------------------------------------------------------------
# stats (reference encoding/integer/stats.py)
# ---------------------------------------------------------------------------


def minimum_error_correction(read_calls, genotype):
    """Per-read minimum error correction vs a genotype.

    Reference: stats.py:18-39.
    """
    read_calls = np.expand_dims(np.asarray(read_calls), 1)
    genotype = np.expand_dims(np.asarray(genotype), 0)
    diff = (read_calls != genotype) & (read_calls >= 0)
    return diff.sum(axis=-1).min(axis=-1)


def read_assignment(read_calls, haplotypes):
    """Fractional assignment of reads to haplotypes by MEC.

    Reference: stats.py:42-74.
    """
    read_calls = np.expand_dims(np.asarray(read_calls), 1)
    haplotypes = np.expand_dims(np.asarray(haplotypes), 0)
    diff = ((read_calls != haplotypes) & (read_calls >= 0)).sum(axis=-1)
    mec = diff.min(axis=-1, keepdims=True)
    match = diff == mec
    return match / match.sum(axis=-1, keepdims=True)


def kmer_representation(read_calls, genotype, k=3):
    """Position-wise proportion of read kmers present in the genotype.

    Reference: stats.py:77-118.
    """
    from mchap_tpu_torch import mset

    read_kmers, read_kmer_counts = kmer_counts(read_calls, k=k)
    hap_kmers, _ = kmer_counts(genotype, k=k)
    if np.prod(read_kmers.shape) == 0:
        _, n_pos = hap_kmers.shape if hap_kmers.ndim == 2 else (0, np.asarray(genotype).shape[-1])
        return np.ones(n_pos)
    novel = mset.count(hap_kmers, read_kmers) == 0
    unique_depth = depth(read_kmers[novel], read_kmer_counts[novel])
    total_depth = depth(read_kmers, read_kmer_counts)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 1 - np.where(total_depth > 0, unique_depth / total_depth, 0)


def kmer_coverage(read_calls, genotype, k=3):
    """Per-window counts of read kmers covered by genotype kmers.

    Vectorized form of reference ``kmer_coverage`` (stats.py:121-141).
    Returns (covered, total) float[n_windows].
    """
    read_calls = np.asarray(read_calls)
    genotype = np.asarray(genotype)
    n_base = genotype.shape[-1]
    n_windows = n_base - (k - 1)
    if n_windows <= 0:
        return np.zeros(0), np.zeros(0)
    read_windows = np.lib.stride_tricks.sliding_window_view(read_calls, k, axis=-1)
    hap_windows = np.lib.stride_tricks.sliding_window_view(genotype, k, axis=-1)
    complete = ~np.any(read_windows < 0, axis=-1)  # [R, W]
    # match[r, w] = any haplotype whose window equals the read window
    match = np.any(
        np.all(read_windows[:, None, :, :] == hap_windows[None, :, :, :], axis=-1),
        axis=1,
    )  # [R, W]
    total = complete.sum(axis=0).astype(float)
    covered = (complete & match).sum(axis=0).astype(float)
    return covered, total


def min_kmer_coverage(read_calls, genotype, ks):
    """Minimum kmer coverage across windows for several k.

    Reference: stats.py:144-181.
    """
    read_calls = np.asarray(read_calls)
    n = len(ks)
    n_base = read_calls.shape[-1]
    out = np.zeros(n)
    for i, k in enumerate(ks):
        if n_base < k:
            out[i] = np.nan
            continue
        num, denom = kmer_coverage(read_calls, genotype, k=k)
        if len(denom) == 0 or np.all(denom == 0):
            out[i] = np.nan
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                out[i] = np.min(np.where(denom > 0, num / denom, 1))
    return out
