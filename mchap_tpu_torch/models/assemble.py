"""DenovoMCMC model: de novo haplotype assembly by batched MCMC (PyTorch).

Port of ``mchap_tpu/models/assemble.py`` (reference
``mchap/assemble/mcmc.py`` and ``classes.py``).  Every (locus, sample)
problem of a block and its chains run through one launch of K1
(``ops/cuda_denovo.py``): the CUDA kernel on a card, its plain PyTorch
version on the CPU.  Homozygote-fixed positions stay in the state with
n_alleles = 1, and the wrapper compacts each problem's het positions to
the front before the launch.  A tempering ladder (``temperatures``) and
the Dirichlet-multinomial prior (per-sample ``inbreeding``) run inside
K1; what K1 cannot run is refused up front (``refuse_unsupported``).
"""

from collections import Counter
from dataclasses import dataclass
from functools import reduce

import numpy as np
import torch
from scipy import stats as _stats

from mchap_tpu_torch import mset
from mchap_tpu_torch.ops import assemble_mcmc as _screen
from mchap_tpu_torch.ops.cuda_denovo import (
    denovo_sampler,
    draw_layout,
    k1_unsupported_reason,
    next_pow2,
    unpack_genotype_trace,
)
from mchap_tpu_torch.ops.likelihood import MIN_LOG
from mchap_tpu_torch.ops.trace_tab import (
    decode_tabulated_states,
    tabulate_packed_trace,
)
from mchap_tpu_torch.utils import fallback as _fallback
from mchap_tpu_torch.utils import timing as _timing
from mchap_tpu_torch.utils.device import resolve_device


def _point_beta_probabilities(n_base, a=1, b=1):
    """Discretized Beta pmf over break counts; reference mcmc.py:429-452."""
    dist = _stats.beta(a, b)
    points = np.arange(1, n_base + 1) / n_base
    probs = dist.cdf(points)
    probs[1:] = probs[1:] - probs[:-1]
    return probs


def _read_mean_dist(reads):
    """Per-position allele profile for chain initialisation.

    The mean of the observed read distributions at each (position,
    allele) cell; cells no read observed get a uniform share over the
    position's allowed alleles (disallowed slots are all-zero columns
    and keep probability 0).  Reference mcmc.py:455-491.
    """
    reads = np.asarray(reads, float)
    observed = ~np.isnan(reads)  # [R, nb, A]
    n_obs = observed.sum(axis=0)  # [nb, A]
    total = np.where(observed, reads, 0.0).sum(axis=0)
    mean = total / np.maximum(n_obs, 1)
    allowed = ~np.all(np.nan_to_num(reads, nan=1.0) == 0.0, axis=0)
    uniform = 1.0 / allowed.sum(axis=1, keepdims=True)
    dist = np.where(n_obs > 0, mean, uniform)
    return dist / dist.sum(axis=-1, keepdims=True)


def pad_reads_bucket(reads_list, counts_list, min_bucket=8, fill=np.nan):
    """Pad per-sample reads to a shared power-of-two read count; padded
    reads are ``fill`` (nan, log 1, by default) with count 0, so they
    weigh nothing."""
    max_r = max((len(r) for r in reads_list), default=0)
    bucket = min_bucket
    while bucket < max_r:
        bucket *= 2
    shape = reads_list[0].shape[1:]
    n = len(reads_list)
    reads = np.full((n, bucket) + shape, fill)
    counts = np.zeros((n, bucket))
    for i, (r, c) in enumerate(zip(reads_list, counts_list)):
        reads[i, : len(r)] = r
        counts[i, : len(c)] = c
    return reads, counts


def refuse_unsupported(ploidy, n_reads_bucket, n_base, n_temps, inbreeding):
    """Raise NotImplementedError, before any device work, for a
    configuration K1 cannot run (``k1_unsupported_reason``): the port
    has no other de novo sampler yet."""
    reason = k1_unsupported_reason(
        ploidy, n_reads_bucket, n_base, n_temps, inbreeding
    )
    if reason is not None:
        raise NotImplementedError(
            f"the de novo sampler K1 cannot run {reason}; the torch de novo"
            " sampler that would is not ported yet (ROADMAP queue 1, item 2)"
        )


@dataclass
class DenovoMCMC:
    """De novo assembly sampler; attributes as reference mcmc.py:24-100.

    ``fit`` runs the batched core with one problem.  ``device`` is
    ``"cuda"`` (the default; raises without a card) or ``"cpu"``.
    """

    ploidy: int
    n_alleles: list
    inbreeding: float = None
    steps: int = 1000
    chains: int = 2
    alpha: float = 1.0
    beta: float = 3.0
    n_intervals: int = None
    fix_homozygous: float = 0.999
    recombination_step_probability: float = 0.5
    partial_dosage_step_probability: float = 0.5
    dosage_step_probability: float = 1.0
    temperatures: tuple = (1.0,)
    random_seed: int = None
    llk_cache_threshold: int = 100  # accepted for API parity; no cache here
    device: str = "cuda"

    def fit(self, reads, read_counts=None, initial=None):
        """Run ``chains`` MCMC chains; returns GenotypeMultiTrace.

        Reference semantics: mcmc.py:103-265 (zero-read mock, homozygote
        fixing, read-mean initialisation, all-fixed shortcut).
        """
        if self.n_intervals is not None:
            raise NotImplementedError(
                "fixed n_intervals is not ported; K1 draws Bernoulli"
                " interval partitions"
            )
        reads = np.asarray(reads, float)
        n_reads, n_pos, max_allele = reads.shape
        if n_reads == 0:
            reads = np.full((1, n_pos, max_allele), np.nan)
            read_counts = None
        if read_counts is None:
            read_counts = np.ones(len(reads))
        if n_pos == 0:
            genotypes = np.zeros((self.chains, self.steps, self.ploidy, 0), np.int8)
            llks = np.full((self.chains, self.steps), np.nan)
            return GenotypeMultiTrace(genotypes, llks)
        if initial is not None:
            initial = np.asarray(initial)
            if initial.ndim == 2:
                initial = np.tile(initial, (self.chains, 1, 1))
            initial = initial[None]
        return _fit_denovo_core(
            reads[None], np.asarray(read_counts, float)[None],
            np.asarray(self.n_alleles, np.int32)[None], self.ploidy,
            None if self.inbreeding is None else [self.inbreeding],
            self.steps, self.chains, self.alpha,
            self.beta, self.fix_homozygous,
            self.recombination_step_probability,
            self.partial_dosage_step_probability,
            self.dosage_step_probability, self.temperatures,
            self.random_seed, device=resolve_device(self.device),
            tabulate=False, initial=initial,
        )[0]


def _fit_denovo_batch_kernel(
    log_reads, counts, init, n_alleles_eff, break_dist, ploidy, steps,
    chains, seed, p_recomb, p_partial, p_full, device, burn=0,
    tabulate=False, pinned_noise=None, temperatures=(1.0,), alphas=None,
):
    """Run all samples x chains through one K1 launch.

    log_reads f32[S, R, NB, A], counts [S, R], init i32[S, chains, P,
    NB], n_alleles_eff [S, NB] (1 = fixed), break_dist [S, NB],
    ``temperatures`` the ascending ladder, ``alphas`` [S] the
    Dirichlet-multinomial dispersions (None: flat prior).  Chain
    ``i * chains + c`` is chain c of problem i; the reads stay per
    problem.  With ``tabulate`` the kept trace is tabulated where it
    lies and only distinct states cross to the host.  ``pinned_noise``
    (a float) replaces every uniform draw of the sampler (tests).
    Returns one trace per problem.
    """
    log_reads = np.asarray(log_reads, np.float32)
    init = np.asarray(init, np.int32)
    n_alleles_eff = np.asarray(n_alleles_eff, np.int32)
    counts = np.asarray(counts)
    break_dist = np.asarray(break_dist)
    n_samples, n_reads, n_pos_full, max_allele = log_reads.shape
    # the Bernoulli breakpoint rate targets the reference's expected
    # break count over the ORIGINAL position axis (mcmc.py:429-452)
    mean_breaks = (break_dist * np.arange(n_pos_full)[None, :]).sum(-1)

    # --- het-position compaction -------------------------------------
    # Fixed and padding positions (n_alleles <= 1) never move, and the
    # sweep cost is linear in NB: compact each problem's het positions
    # to the front (stable, so relative order is kept), run the kernel
    # on the max-het-width prefix, and restore the fixed columns after.
    # Fixed columns add a genotype-independent constant to every rh row,
    # so dropping them shifts each problem's llk by
    # sum_r c_r * sum_{j fixed} lr[r, j, fixed_allele], added back below.
    het = n_alleles_eff > 1  # [S, NB]
    nb_eff = int(het.sum(axis=1).max(initial=1))
    nb_eff = min(n_pos_full, (max(nb_eff, 1) + 7) // 8 * 8)
    restore = None
    fix_llk = np.zeros(n_samples)
    if nb_eff < n_pos_full:
        order = np.argsort(~het, axis=1, kind="stable")  # het first
        sel = order[:, :nb_eff]  # [S, nb_eff]
        if not bool(
            np.all((init == init[:, :1, :1, :]) | het[:, None, None, :])
        ):
            raise ValueError(
                "het compaction: init differs across chains/rows at a"
                " fixed position"
            )
        fixed_allele_full = init[:, 0, 0, :]  # fixed cols: all rows equal
        lr_fix = np.take_along_axis(
            log_reads, fixed_allele_full[:, None, :, None].astype(np.int64),
            axis=3,
        )[..., 0]  # [S, R, NB]
        # the constant covers only positions outside the kernel
        in_kernel = np.zeros((n_samples, n_pos_full), bool)
        np.put_along_axis(in_kernel, sel, True, axis=1)
        fix_llk = (
            np.where(in_kernel[:, None, :], 0.0, lr_fix).sum(axis=2) * counts
        ).sum(axis=1)
        log_reads = np.take_along_axis(log_reads, sel[:, None, :, None], axis=2)
        init = np.take_along_axis(init, sel[:, None, None, :], axis=3)
        n_alleles_eff = np.take_along_axis(n_alleles_eff, sel, axis=1)
        restore = (sel, fixed_allele_full)
    n_pos = log_reads.shape[2]

    def _restore_cols(arr, i):
        """Compact [..., nb_eff] positions back to [..., n_pos_full]."""
        if restore is None:
            return arr
        sel_r, fa_full = restore
        inv = np.full(n_pos_full, -1, np.int64)
        inv[sel_r[i]] = np.arange(n_pos)
        gathered = arr[..., np.maximum(inv, 0)]
        return np.where(inv >= 0, gathered, fa_full[i]).astype(arr.dtype)

    b = n_samples * chains

    def _dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(device)

    lr_t = _dev(log_reads.transpose(0, 2, 3, 1), torch.float32)  # [S, NB, A, R]
    counts_t = _dev(counts, torch.float32)
    g0 = _dev(init.transpose(2, 3, 0, 1).reshape(ploidy, n_pos, b), torch.int32)
    nall_t = _dev(n_alleles_eff, torch.int32)
    # per-problem Bernoulli breakpoint rate matching the reference's
    # expected break count, spread over the (compacted) position axis
    pbreak = _dev(mean_breaks / max(n_pos - 1, 1), torch.float32)
    problem = _dev(np.repeat(np.arange(n_samples), chains), torch.int32)
    alpha_t = None if alphas is None else _dev(alphas, torch.float32)
    noise = None
    if pinned_noise is not None:
        D = draw_layout(ploidy, n_pos, len(temperatures))["D"]
        noise = torch.full((steps, D, b), float(pinned_noise), device=device)
    with _timing.stage("device.kernel"):
        packed, llks = denovo_sampler(
            lr_t, counts_t, g0, nall_t, pbreak, problem, n_steps=steps,
            p_recomb=p_recomb, p_partial=p_partial, p_full=p_full,
            seed=seed, noise=noise, temps=temperatures, alpha=alpha_t,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    kept = steps - burn
    base = next_pow2(max(max_allele, 2))
    if tabulate and kept > 0:
        # distinct genotype states + multiplicities per chain, tabulated
        # on the device (reference tabulation semantics classes.py:307-325)
        n_cap = min(kept, 512)
        with _timing.stage("device.tabulate"):
            words, counts_t, first_t, n_uniq, llks_t = tabulate_packed_trace(
                packed, llks, ploidy=ploidy, base=base, n_cap=n_cap, burn=burn,
            )
            max_u = int(n_uniq.max())
        if max_u <= n_cap:
            k = min(next_pow2(max_u), words.shape[0])
            with _timing.stage("device.trace_fetch"):
                words_h = words[:k].cpu().numpy()
                counts_h = counts_t[:k].cpu().numpy()
                first_h = first_t[:k].cpu().numpy()
                llks_h = llks_t[:k].cpu().numpy()
            with _timing.stage("device.trace_unpack"):
                alleles = decode_tabulated_states(words_h, ploidy, base)
            st = alleles.reshape(k, ploidy, n_pos, n_samples, chains).transpose(
                3, 4, 0, 1, 2
            )  # [S, C, k, P, NB]
            cnts = counts_h.reshape(k, n_samples, chains).transpose(1, 2, 0)
            firsts = first_h.reshape(k, n_samples, chains).transpose(1, 2, 0)
            llks_r = llks_h.reshape(k, n_samples, chains).transpose(1, 2, 0)
            return [
                TabulatedGenotypeTrace(
                    _restore_cols(st[i], i),
                    cnts[i],
                    firsts[i],
                    (llks_r[i] + fix_llk[i]).astype(float),
                    pre_burned=burn,
                    kept=kept,
                )
                for i in range(n_samples)
            ]
        # > n_cap distinct states in some chain: fetch the full kept trace
        _fallback.note_path("denovo-tabulate", "overflow-full-fetch")

    with _timing.stage("device.trace_fetch"):
        packed_host = packed[burn:].cpu().numpy()
        llks = llks[burn:].cpu().numpy()
    with _timing.stage("device.trace_unpack"):
        genotypes = unpack_genotype_trace(packed_host, ploidy, max_allele)
    genotypes = genotypes.reshape(kept, ploidy, n_pos, n_samples, chains)
    genotypes = genotypes.transpose(3, 4, 0, 1, 2)  # [S, chains, kept, P, NB]
    llks = llks.reshape(kept, n_samples, chains).transpose(1, 2, 0)
    out = []
    for i in range(n_samples):
        t = GenotypeMultiTrace(
            _restore_cols(genotypes[i], i),
            (llks[i] + fix_llk[i]).astype(float),
        )
        t.pre_burned = burn
        out.append(t)
    return out


def fit_denovo_batch(
    ploidy,
    n_alleles,
    reads_list,
    counts_list,
    inbreeding_list=None,
    steps=1000,
    chains=2,
    alpha=1.0,
    beta=3.0,
    fix_homozygous=0.999,
    recombination_step_probability=0.5,
    partial_dosage_step_probability=0.5,
    dosage_step_probability=1.0,
    temperatures=(1.0,),
    random_seed=None,
    burn=0,
    device=None,
):
    """Run the de novo assembler for MANY samples of one locus in one
    launch.  Returns one trace per sample."""
    n_samples = len(reads_list)
    n_alleles = np.array(n_alleles, dtype=np.int8)
    n_pos = len(n_alleles)
    if n_pos == 0:
        return [
            GenotypeMultiTrace(
                np.zeros((chains, steps, ploidy, 0), np.int8),
                np.full((chains, steps), np.nan),
            )
            for _ in range(n_samples)
        ]
    # mock zero-read samples with a single all-gap read (mcmc.py:132-137)
    reads_list = [
        r if len(r) else np.full((1,) + r.shape[1:], np.nan) for r in reads_list
    ]
    counts_list = [c if len(c) else np.ones(1) for c in counts_list]
    reads, counts = pad_reads_bucket(reads_list, counts_list)
    n_alleles_mat = np.broadcast_to(n_alleles[None, :], (n_samples, n_pos)).copy()
    return _fit_denovo_core(
        reads, counts, n_alleles_mat, ploidy, inbreeding_list,
        steps, chains, alpha, beta, fix_homozygous,
        recombination_step_probability, partial_dosage_step_probability,
        dosage_step_probability, temperatures, random_seed, burn=burn,
        device=resolve_device(device),
    )


def _fit_denovo_core(
    reads, counts, n_alleles_mat, ploidy, inbreeding,
    steps, chains, alpha, beta, fix_homozygous,
    recombination_step_probability, partial_dosage_step_probability,
    dosage_step_probability, temperatures, random_seed, burn=0, *,
    device, tabulate=True, initial=None,
):
    """Shared batched-assembly core over pre-padded arrays.

    ``n_alleles_mat`` is per problem ([S, nb]); positions with
    n_alleles <= 1 (cross-locus padding) are forced homozygous-fixed at
    allele 0.  ``inbreeding`` [S] selects the Dirichlet-multinomial
    prior (None: flat).  Initial genotypes and the sampler seed both
    come from one ``torch.Generator`` seeded with ``random_seed``.
    """
    temps = np.sort(np.asarray(temperatures, float))
    if temps[-1] != 1.0:
        raise ValueError("the last (coldest) temperature must be 1.0")
    n_samples, n_reads, n_pos, _ = reads.shape
    refuse_unsupported(ploidy, n_reads, n_pos, len(temps), inbreeding)

    with _timing.stage("device.homfilter"):
        hom = _screen.homozygosity_probabilities_batch(
            reads, n_alleles_mat, ploidy, read_counts_b=counts,
            inbreeding_b=inbreeding,
        )  # [S, nb, A]
    fixed = hom >= fix_homozygous
    homozygous = np.any(fixed, axis=-1) | (n_alleles_mat <= 1)  # [S, nb]
    fixed_allele = np.where(np.any(fixed, axis=-1), np.argmax(fixed, axis=-1), 0)
    fixed_allele = np.where(homozygous, fixed_allele, 0)
    n_alleles_eff = np.where(homozygous, 1, n_alleles_mat).astype(np.int32)
    n_het = (~homozygous).sum(axis=-1)
    alphas = None
    if inbreeding is not None:
        # DM dispersion (1 - F) / F / u_haps over the haplotypes that the
        # fixed genotype space allows (reference prior.py:81-112)
        f = np.asarray(inbreeding, float)
        log_uh = np.log(n_alleles_eff.astype(float)).sum(axis=1)
        alphas = (1.0 - f) / f * np.exp(-log_uh)

    break_dist = np.zeros((n_samples, n_pos))
    for i in range(n_samples):
        if n_het[i] > 0:
            break_dist[i, : n_het[i]] = _point_beta_probabilities(
                int(n_het[i]), alpha, beta
            )
        else:
            break_dist[i, 0] = 1.0

    gen = torch.Generator()
    gen.manual_seed(random_seed if random_seed is not None else 0)
    with _timing.stage("host.chain_init"):
        init = np.zeros((n_samples, chains, ploidy, n_pos), np.int32)
        u_all = torch.rand(
            (n_samples, chains, ploidy, n_pos, 1), generator=gen,
            dtype=torch.float64,
        ).numpy()
        for i in range(n_samples):
            if initial is not None:
                sampled = np.asarray(initial[i], np.int32)
            else:
                dist = _read_mean_dist(reads[i])
                cdf = np.cumsum(dist, axis=-1)
                sampled = (u_all[i] > cdf[None, None]).sum(axis=-1)
            init[i] = np.where(
                homozygous[i][None, None, :], fixed_allele[i][None, None, :],
                sampled,
            )
    kernel_seed = int(torch.randint(0, 2**62, (1,), generator=gen))

    with np.errstate(divide="ignore", invalid="ignore"):
        lr_host = np.maximum(
            np.log(np.where(np.isnan(reads), 1.0, reads)), MIN_LOG
        ).astype(np.float32)
    traces = _fit_denovo_batch_kernel(
        lr_host, counts, init, n_alleles_eff, break_dist, ploidy, steps,
        chains, kernel_seed, recombination_step_probability,
        partial_dosage_step_probability, dosage_step_probability, device,
        burn=burn, tabulate=tabulate, temperatures=tuple(temps), alphas=alphas,
    )
    _fallback.note_path("denovo", "cuda" if device.type == "cuda" else "plain")
    out = []
    kept = steps - burn
    for i in range(n_samples):
        if homozygous[i].all():
            # all-fixed shortcut semantics (nan llks, constant genotype)
            haplotype = fixed_allele[i].astype(np.int8)
            g = np.tile(haplotype, (chains, kept, ploidy, 1))
            t = GenotypeMultiTrace(g, np.full((chains, kept), np.nan))
            t.pre_burned = burn
            out.append(t)
        else:
            out.append(traces[i])
    return out


def fit_denovo_multi(
    problems,
    ploidy,
    steps=1000,
    chains=2,
    alpha=1.0,
    beta=3.0,
    fix_homozygous=0.999,
    recombination_step_probability=0.5,
    partial_dosage_step_probability=0.5,
    dosage_step_probability=1.0,
    temperatures=(1.0,),
    random_seed=None,
    burn=0,
    device=None,
):
    """Run the de novo assembler for problems from MANY LOCI in one
    launch per shape bucket.

    Each problem is a dict with ``reads`` (float[R, nb_i, A_i]),
    ``counts`` (float[R]), ``n_alleles`` (int[nb_i]) and optionally
    ``inbreeding``.  Problems are padded to a common [R_max, nb_max,
    A_max] bucket; padded positions are all-gap reads with n_alleles =
    1, which the sampler never moves.  Buckets split on the allele
    radix (one triallelic site would force a block off the A == 2 fast
    path) and a read class (<= 64 / power of two above), each with its
    own derived seed.  Returns one trace per problem, sliced back to its
    true position count.
    """
    device = resolve_device(device)
    n_prob = len(problems)
    nb_list = [len(p["n_alleles"]) for p in problems]
    a_list = [
        (p["reads"].shape[2] if p["reads"].ndim == 3 and p["reads"].shape[2] else 1)
        for p in problems
    ]
    r_list = [max(len(p["reads"]), 1) for p in problems]

    def _bucket_key(i):
        return (next_pow2(max(a_list[i], 2)), max(64, next_pow2(r_list[i])))

    buckets = {}
    for i in range(n_prob):
        buckets.setdefault(_bucket_key(i), []).append(i)
    if len(buckets) > 1:
        out = [None] * n_prob
        base_seed = random_seed if random_seed is not None else 0
        for ordinal, key in enumerate(sorted(buckets)):
            idxs = buckets[key]
            sub = fit_denovo_multi(
                [problems[i] for i in idxs],
                ploidy,
                steps=steps,
                chains=chains,
                alpha=alpha,
                beta=beta,
                fix_homozygous=fix_homozygous,
                recombination_step_probability=recombination_step_probability,
                partial_dosage_step_probability=partial_dosage_step_probability,
                dosage_step_probability=dosage_step_probability,
                temperatures=temperatures,
                random_seed=base_seed + 7919 * ordinal,
                burn=burn,
                device=device,
            )
            for i, t in zip(idxs, sub):
                out[i] = t
        return out

    nb_max = max(nb_list + [0])
    if nb_max == 0:
        return [
            GenotypeMultiTrace(
                np.zeros((chains, steps, ploidy, 0), np.int8),
                np.full((chains, steps), np.nan),
            )
            for _ in range(n_prob)
        ]
    nb_max = (nb_max + 7) // 8 * 8
    a_max = max(a_list)
    r_max = max(64, next_pow2(max(r_list)))
    inbreeding = None
    if any(p.get("inbreeding") is not None for p in problems):
        inbreeding = [float(p.get("inbreeding") or 0.0) for p in problems]

    reads = np.full((n_prob, r_max, nb_max, a_max), np.nan)
    counts = np.zeros((n_prob, r_max))
    n_alleles_mat = np.ones((n_prob, nb_max), np.int32)
    for i, p in enumerate(problems):
        r_i, nb_i, a_i = len(p["reads"]), nb_list[i], a_list[i]
        if r_i and nb_i:
            reads[i, :r_i, :nb_i, :a_i] = p["reads"]
            # allele slots beyond the problem's own allele axis are
            # impossible observations (prob 0 -> MIN_LOG), not gaps
            reads[i, :r_i, :nb_i, a_i:] = 0.0
            counts[i, :r_i] = p["counts"]
        else:
            # zero reads: single all-gap mock read (mcmc.py:132-137)
            counts[i, 0] = 1.0
        n_alleles_mat[i, :nb_i] = np.asarray(p["n_alleles"], np.int32)

    traces = _fit_denovo_core(
        reads, counts, n_alleles_mat, ploidy, inbreeding,
        steps, chains, alpha, beta, fix_homozygous,
        recombination_step_probability, partial_dosage_step_probability,
        dosage_step_probability, temperatures, random_seed, burn=burn,
        device=device,
    )
    return [tr.truncate_positions(nb_list[i]) for i, tr in enumerate(traces)]


@dataclass
class PosteriorGenotypeDistribution:
    """Posterior over phased genotypes; reference classes.py:54-166."""

    genotypes: np.ndarray  # [n_genotypes, ploidy, n_pos]
    probabilities: np.ndarray

    def mode(self):
        idx = np.argmax(self.probabilities)
        return self.genotypes[idx], self.probabilities[idx]

    def mode_genotype_support(self):
        """Dosage-marginal mode: group genotypes by their allele-support
        set, pick the heaviest group (reference semantics classes.py:87-128).
        """
        # support key = the genotype with duplicate haplotype rows
        # dropped; genotypes here are row-sorted (trace canonicalisation)
        # so equal supports serialize identically
        keys = np.array([mset.unique(g).tobytes() for g in self.genotypes])
        _, first, group = np.unique(keys, return_index=True, return_inverse=True)
        group_probs = np.bincount(group, weights=self.probabilities)
        # argmax with ties resolved to the group appearing earliest in
        # the (descending-probability) posterior ordering
        winner = np.lexsort((first, -group_probs))[0]
        member = group == winner
        return GenotypeSupportDistribution(
            self.genotypes[member], self.probabilities[member]
        )

    def allele_frequencies(self, dosage=False):
        """(haplotypes, frequencies, occurrence); classes.py:130-166."""
        n_gen, ploidy, n_base = self.genotypes.shape
        haps = self.genotypes.reshape(n_gen * ploidy, n_base)
        uhaps = mset.unique(haps)
        freqs = {h.tobytes(): 0.0 for h in uhaps}
        occur = {h.tobytes(): 0.0 for h in uhaps}
        for gen, prob in zip(self.genotypes, self.probabilities):
            counts = Counter(hap.tobytes() for hap in gen)
            for key, dose in counts.items():
                freqs[key] += prob * dose
                occur[key] += prob
        ufreqs = np.array([freqs[h.tobytes()] for h in uhaps])
        uoccur = np.array([occur[h.tobytes()] for h in uhaps])
        if dosage is False:
            ufreqs = ufreqs / ploidy
        return uhaps, ufreqs, uoccur


@dataclass
class GenotypeSupportDistribution:
    """Dosage-alternatives of one allele support; classes.py:169-244."""

    genotypes: np.ndarray
    probabilities: np.ndarray

    def alleles(self):
        return mset.unique(self.genotypes[0])

    def mode_genotype(self):
        idx = np.argmax(self.probabilities)
        return self.genotypes[idx], self.probabilities[idx]

    def call_genotype_support(self, threshold=0.95):
        """Most complete allele set exceeding ``threshold``; pads with
        null alleles when needed (reference semantics classes.py:207-244).

        The smallest probability-descending prefix of dosage alternatives
        whose mass reaches ``threshold`` is intersected (multiset-wise);
        haplotypes shared by every member are called, the rest are null.
        """
        order = np.argsort(-self.probabilities, kind="stable")
        if self.probabilities[order[0]] >= threshold:
            return self.genotypes[order[0]], self.probabilities[order[0]]
        cum = np.cumsum(self.probabilities[order])
        k = min(int(np.searchsorted(cum, threshold)) + 1, len(cum))
        shared = reduce(mset.intercept, list(self.genotypes[order[:k]]))
        _, ploidy, n_pos = self.genotypes.shape
        result = np.full((ploidy, n_pos), -1, dtype=self.genotypes.dtype)
        result[: len(shared)] = shared
        return result, cum[k - 1]


@dataclass
class GenotypeMultiTrace:
    """Multi-chain trace of phased genotypes; classes.py:247-376."""

    genotypes: np.ndarray  # [n_chains, n_steps, ploidy, n_pos]
    llks: np.ndarray

    def __post_init__(self):
        if (self.genotypes is not None) and (self.genotypes.shape[-1] != 0):
            g = np.array(self.genotypes)
            assert g.ndim == 4
            n_chains, n_steps, ploidy, n_pos = g.shape
            # canonical per-step ordering: lexicographic row sort, fully
            # vectorized (replaces the reference's per-step python loop)
            flat = g.reshape(n_chains * n_steps, ploidy, n_pos)
            keys = flat.transpose(2, 0, 1)[::-1]  # [n_pos, N, ploidy]
            order = np.lexsort(tuple(keys))  # [N, ploidy]
            flat = np.take_along_axis(flat, order[..., None], axis=1)
            self.genotypes = flat.reshape(g.shape)
            self.llks = np.array(self.llks)

    def burn(self, n):
        """Drop the first ``n`` steps of the ORIGINAL trace.

        Batched device paths may pre-slice the burn-in on device (less
        device->host traffic) and record it in ``pre_burned``; burning
        by the same n again is then a no-op, so application code calls
        ``.burn(mcmc_burn)`` uniformly either way.
        """
        pre = getattr(self, "pre_burned", 0)
        k = max(n - pre, 0)
        new = type(self)(None, None)
        new.genotypes = self.genotypes[:, k:]
        new.llks = self.llks[:, k:]
        new.pre_burned = max(n, pre)
        return new

    def posterior(self):
        n_chain, n_step, ploidy, n_base = self.genotypes.shape
        if n_base == 0:
            return PosteriorGenotypeDistribution(
                np.zeros((1, ploidy, 0), self.genotypes.dtype), np.ones(1)
            )
        genotypes = self.genotypes.reshape(n_chain * n_step, ploidy * n_base)
        with _timing.stage("host.posterior_tab"):
            states, counts = mset.unique_counts(genotypes)
        probs = counts / counts.sum()
        idx = np.flip(np.argsort(probs, kind="stable"))
        return PosteriorGenotypeDistribution(
            states[idx].reshape(len(states), ploidy, n_base), probs[idx]
        )

    def split(self):
        for genotypes, llks in zip(self.genotypes, self.llks):
            new = type(self)(None, None)
            new.genotypes = genotypes[None]
            new.llks = llks[None]
            yield new

    def truncate_positions(self, n_pos):
        """Trace restricted to the leading ``n_pos`` positions.

        Used to strip cross-locus padding positions, which are frozen
        (n_alleles = 1) and identical across every state, so truncation
        never merges distinct genotypes.
        """
        new = type(self)(None, None)
        new.genotypes = self.genotypes[..., :n_pos]
        new.llks = self.llks
        new.pre_burned = getattr(self, "pre_burned", 0)
        return new

    def replicate_incongruence(self, threshold=0.6):
        """0/1/2 = none / incongruent / putative CNV; classes.py:341-376."""
        return _replicate_incongruence(self, threshold)


def _replicate_incongruence(trace, threshold):
    """Shared MCI computation over any trace with split()/posterior()."""
    out = 0
    posteriors = [chain.posterior() for chain in trace.split()]
    chain_modes = [dist.mode_genotype_support() for dist in posteriors]
    alleles = [
        mode.alleles()
        for mode in chain_modes
        if mode.probabilities.sum() >= threshold
    ]
    mode_count = len({array.tobytes() for array in alleles})
    if mode_count > 1:
        out = 1
        ploidy = len(alleles[0])
        allele_count = len(reduce(mset.union, alleles))
        if allele_count > ploidy:
            out = 2
    return out


class TabulatedGenotypeTrace:
    """Device-tabulated MCMC trace: distinct states + counts per chain.

    The posterior-equivalent summary of a ``GenotypeMultiTrace`` with
    O(n_unique) instead of O(n_steps) host memory and device->host
    traffic (ops/trace_tab.py).  Carries, per chain, the distinct
    genotype states (canonical row order), their multiplicities over
    the kept steps, and each state's first-occurrence step index — the
    exact information ``posterior()`` / ``replicate_incongruence()``
    consume (reference classes.py:307-376), with first-seen ordering
    preserved so probability ties resolve identically to the full-trace
    path.

    ``llks`` here is PER-STATE (each distinct state's log-likelihood at
    its first occurrence, aligned with ``states``/``counts``), not the
    per-step llk sequence of ``GenotypeMultiTrace`` — the VCF pipeline
    never consumes the step sequence (GL/GP come from exact
    enumeration, application/assemble.py:234-258), so fetching it
    through the device link would defeat the O(n_unique) transfer this
    class exists for.
    """

    def __init__(self, states, counts, first, llks, pre_burned=0, kept=None):
        self.states = np.asarray(states)  # [chains, k, ploidy, n_pos] int8
        self.counts = np.asarray(counts)  # [chains, k]
        self.first = np.asarray(first)  # [chains, k] kept-step index
        self.llks = np.asarray(llks)  # [chains, k] per-state llk
        self.pre_burned = pre_burned
        self.kept = int(self.counts.sum(axis=1).max()) if kept is None else kept

    def burn(self, n):
        """No-op when the burn-in was already sliced on device."""
        if max(n - self.pre_burned, 0):
            raise ValueError(
                "tabulated trace cannot burn beyond its device-side "
                f"burn-in ({self.pre_burned} steps)"
            )
        return self

    def truncate_positions(self, n_pos):
        """See GenotypeMultiTrace.truncate_positions."""
        return TabulatedGenotypeTrace(
            self.states[..., :n_pos],
            self.counts,
            self.first,
            self.llks,
            self.pre_burned,
            self.kept,
        )

    def posterior(self):
        n_chains, k, ploidy, n_pos = self.states.shape
        if n_pos == 0:
            return PosteriorGenotypeDistribution(
                np.zeros((1, ploidy, 0), self.states.dtype), np.ones(1)
            )
        mask = self.counts > 0
        flat = self.states[mask]  # [M, ploidy, n_pos]
        cnt = self.counts[mask].astype(float)
        chain_of = np.broadcast_to(
            np.arange(n_chains)[:, None], (n_chains, k)
        )[mask]
        # global first-seen index over the chain-major flattened trace
        # (the order mset.unique_counts sees in the full-trace path)
        seen = chain_of.astype(np.int64) * self.kept + self.first[mask]
        keys = mset._keys(flat.reshape(len(flat), ploidy * n_pos))
        uniq, rep_idx, inverse = np.unique(
            keys, return_index=True, return_inverse=True
        )
        totals = np.bincount(inverse, weights=cnt)
        first_seen = np.full(len(uniq), np.iinfo(np.int64).max)
        np.minimum.at(first_seen, inverse, seen)
        order = np.argsort(first_seen, kind="stable")
        states_u = flat[rep_idx][order]
        probs = totals[order] / totals.sum()
        idx = np.flip(np.argsort(probs, kind="stable"))
        return PosteriorGenotypeDistribution(states_u[idx], probs[idx])

    def split(self):
        for c in range(self.states.shape[0]):
            yield TabulatedGenotypeTrace(
                self.states[c : c + 1],
                self.counts[c : c + 1],
                self.first[c : c + 1],
                self.llks[c : c + 1],
                self.pre_burned,
                self.kept,
            )

    def replicate_incongruence(self, threshold=0.6):
        """0/1/2 = none / incongruent / putative CNV; classes.py:341-376."""
        return _replicate_incongruence(self, threshold)


def call_posterior_haplotypes(posteriors, threshold=0.01):
    """Pool per-sample posteriors into a population allele panel.

    Every haplotype whose occurrence probability reaches ``threshold``
    in at least one sample enters the panel; alleles are weighted by
    their summed posterior dosage across samples and emitted in VCF
    order — the reference (all-zero) haplotype first, alternates by
    descending pooled weight.  Returns ``(haplotypes, ref_observed)``.
    Output-contract semantics match reference haplotype_calling.py:4-64
    (re-derived on stacked arrays rather than per-haplotype dicts).
    """
    n_base = posteriors[0].genotypes.shape[-1]
    kept = []
    kept_weights = []
    for post in posteriors:
        haps, weights, probs = post.allele_frequencies(dosage=True)
        supported = probs >= threshold
        kept.append(haps[supported])
        kept_weights.append(weights[supported])
    pool = np.concatenate(
        [np.asarray(h).reshape(len(h), n_base) for h in kept], axis=0
    ).astype(np.int8)
    pool_weights = np.concatenate(kept_weights)

    # sum weights over duplicate rows, keeping first-appearance order
    # (the tie-break order of the final sort)
    uniq, first, inverse = np.unique(
        pool, axis=0, return_index=True, return_inverse=True
    )
    totals = np.bincount(inverse, weights=pool_weights, minlength=len(uniq))
    appearance = np.argsort(first, kind="stable")
    uniq, totals = uniq[appearance], totals[appearance]

    # the reference allele is emitted first whether observed or not
    is_ref = np.all(uniq == 0, axis=1)
    ref_observed = bool(is_ref.any())
    alts, alt_weights = uniq[~is_ref], totals[~is_ref]
    panel = np.concatenate([alts, np.zeros((1, n_base), np.int8)], axis=0)
    weights = np.append(alt_weights, alt_weights.max(initial=-1.0) + 1.0)
    order = np.flip(np.argsort(weights, kind="stable"))
    return panel[order], ref_observed
