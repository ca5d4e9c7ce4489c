"""De novo assembly MCMC in batched PyTorch: the torch de novo sampler.

Port of ``mchap_tpu/ops/assemble_mcmc.py`` (reference assemble/mutation.py,
structural.py, tempering.py and mcmc.py).  The torch de novo route runs
what K1 (``ops/cuda_denovo.py``) does not: a Dirichlet-multinomial prior
where some sample has inbreeding 0, more than 8 tempering rungs, ploidy
above 12, a rung state above K1's slot, and a fixed number of intervals
(``DenovoMCMC(n_intervals=...)``).  On a card that route is K4
(``ops/cuda_denovo_route.py``); ``denovo_sampler`` here is its plain
version, which the route runs on the CPU.

Every chain of a call is one row of a batch axis ordered (problem, chain,
rung), so each sub-step is a handful of tensor operations over all of
them at once; the sites of a sweep and the intervals of a structural
sweep are a Python loop of fixed length.  Chains visit their own site
and interval orders: each chain's (haplotype, position) is gathered with
index tensors.  The state, as in the JAX sampler:

- ``genotype`` long [B, P, NB];
- ``rh`` f64 [B, R, P], log P(read | haplotype row), updated by a rank-1
  step per mutation and by swapping interval partial sums per structural
  move;
- ``llk`` f64 [B].

Positions with ``n_alleles == 1`` (homozygote-fixed or padding) take no
move in any sub-step.  Every draw of a step comes from one
``utils.philox.keyed_uniforms`` call, keyed by the seed and each row's
index in the whole block, so how a block is split over devices and
processes changes no draw; and every read sum is an elementwise product
and a sum, not a batched matmul, whose sums on a card depend on its
batch size, so a row's llks do not depend on its shard either.  The
stream is not JAX's, so the sampler is held to the same posteriors, not
the same draws.  The sub-steps take their draws as arguments, so tests
can feed them JAX's.

The per-position homozygosity screen that runs before sampling (reference
assemble/mcmc.py:168-199 and snpcalling.py:14-70) is host code here (a
few BLAS calls per block): an f32 dosage product and per-read log, an f64
read reduction and normalisation, and with a Dirichlet-multinomial prior
the f64 ``ops/priors.log_genotype_prior`` of each genotype.
"""

import functools
import itertools
import math

import numpy as np
import torch

from mchap_tpu_torch.numerics.combinadics import (
    enumerate_genotypes,
    genotype_alleles_as_index,
)
from mchap_tpu_torch.ops.exact import genotype_dosage_table
from mchap_tpu_torch.ops.priors import log_genotype_prior, log_genotype_prior_dosage
from mchap_tpu_torch.utils.device import memory_budget
from mchap_tpu_torch.utils.philox import keyed_uniforms

_NEG = -1e300
_F64 = torch.float64


# ---------------------------------------------------------------------------
# option tables (reference assemble/structural.py)
# ---------------------------------------------------------------------------


def _dosage_from_eq(eq):
    """Haplotype dosage vector from a pairwise row-equality matrix.

    Reference ``get_haplotype_dosage`` (jitutils.py:378-422): the count is
    credited to the first row of each equal group, 0 to its copies.
    ``eq``: bool[..., p, p].
    """
    p = eq.shape[-1]
    tri = torch.tril(torch.ones((p, p), dtype=torch.bool, device=eq.device), -1)
    first = ~torch.any(eq & tri, dim=-1)
    return torch.where(first, eq.sum(dim=-1), 0)


def _row_eq(genotype, mask=None):
    """Pairwise row equality of genotype [..., p, nb] rows, only at the
    positions where ``mask`` [..., nb] is True when given."""
    diff = genotype[..., :, None, :] != genotype[..., None, :, :]
    if mask is not None:
        diff = diff & mask[..., None, None, :]
    return ~torch.any(diff, dim=-1)


def _first_occurrence_labels(eq):
    """Label rows by the index of their first equal row (reference
    ``_label_haplotypes``, structural.py:310-361)."""
    p = eq.shape[-1]
    ar = torch.arange(p, device=eq.device)
    allowed = eq & (ar[None, :] <= ar[:, None])
    return torch.where(allowed, ar, p).min(dim=-1).values


def segment_labels(genotype, interval_mask):
    """[..., p, 2] labels: col 0 inside the interval, col 1 outside.

    Reference ``haplotype_segment_labels`` (structural.py:393-430).
    """
    inside = _first_occurrence_labels(_row_eq(genotype, interval_mask))
    outside = _first_occurrence_labels(_row_eq(genotype, ~interval_mask))
    return torch.stack([inside, outside], dim=-1)


def _labels_dosage(labels):
    """Dosage over [..., p, 2] label rows (rows equal iff both labels equal)."""
    l0, l1 = labels[..., 0], labels[..., 1]
    eq = (l0[..., :, None] == l0[..., None, :]) & (l1[..., :, None] == l1[..., None, :])
    return _dosage_from_eq(eq)


def _segment_dosage(labels):
    """Dosage over the interval-segment labels (col 0 only)."""
    return _dosage_from_eq(labels[..., :, None, 0] == labels[..., None, :, 0])


@functools.lru_cache(maxsize=None)
def _pair_tables(ploidy, swap, device):
    """(h0 [K], h1 [K], src [K, p]) of the recombination pairs h0 < h1
    (``swap``: rows h0 and h1 exchange their segments) or of the ordered
    dosage pairs h0 != h1 (row h0 takes row h1's segment).  ``src[k]`` is
    the row each row's segment comes from under option k."""
    if swap:
        pairs = list(itertools.combinations(range(ploidy), 2))
    else:
        pairs = list(itertools.permutations(range(ploidy), 2))
    src = np.tile(np.arange(ploidy), (max(len(pairs), 1), 1))[: len(pairs)]
    for k, (h0, h1) in enumerate(pairs):
        src[k, h0] = h1
        if swap:
            src[k, h1] = h0
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)  # noqa: E731
    return as_t(pairs[:, 0]), as_t(pairs[:, 1]), as_t(src)


def _options(labels, src):
    """Option label matrices [..., K, p, 2]: segment labels from ``src``."""
    col1 = labels[..., None, :, 1].expand(labels.shape[:-2] + src.shape)
    return torch.stack([labels[..., 0][..., src], col1], dim=-1)


def _recombination_pairs(labels):
    """[..., p, p]: option (h0, h1) of the recombination table is valid
    (read for h0 < h1): both rows are the first of their haplotype and
    their segments differ inside and outside the interval."""
    first = _labels_dosage(labels) != 0
    l0, l1 = labels[..., 0], labels[..., 1]
    return (
        (first[..., :, None] & first[..., None, :])
        & (l0[..., :, None] != l0[..., None, :])
        & (l1[..., :, None] != l1[..., None, :])
    )


def recombination_options(labels):
    """All C(p, 2) recombination option label-matrices + validity mask.

    Reference ``recombination_step_options`` (structural.py:121-178).
    ``labels`` [..., p, 2]; returns (options [..., K, p, 2], valid [..., K]).
    """
    h0, h1, src = _pair_tables(labels.shape[-2], True, labels.device)
    return _options(labels, src), _recombination_pairs(labels)[..., h0, h1]


def recombination_n_options(labels):
    """Count of valid recombination options; structural.py:74-118."""
    return torch.triu(_recombination_pairs(labels), 1).sum(dim=(-2, -1))


def _dosage_pairs(labels):
    """[..., p, p]: option (h0, h1) of the dosage table is valid (read
    for h0 != h1): h0 is the first of its haplotype and not alone in its
    segment, h1 the first of its segment, and their segments differ."""
    hap_dosage = _labels_dosage(labels)
    seg_dosage = _segment_dosage(labels)
    l0 = labels[..., 0]
    return (
        ((hap_dosage != 0) & (seg_dosage != 1))[..., :, None]
        & (seg_dosage != 0)[..., None, :]
        & (l0[..., :, None] != l0[..., None, :])
    )


def dosage_options(labels):
    """All p * (p - 1) dosage-swap option label-matrices + validity mask.

    Reference ``dosage_step_options`` (structural.py:240-307): receiver
    h0's segment is overwritten with donor h1's segment.
    """
    h0, h1, src = _pair_tables(labels.shape[-2], False, labels.device)
    return _options(labels, src), _dosage_pairs(labels)[..., h0, h1]


def dosage_n_options(labels):
    """Count of valid dosage options; structural.py:181-237.  The
    diagonal of ``_dosage_pairs`` is False (equal segments)."""
    return _dosage_pairs(labels).sum(dim=(-2, -1))


def _inverse_cdf_choice(probabilities, u):
    """Reference random_choice semantics (searchsorted on the cumsum):
    probabilities [B, K], u [B] -> long [B]."""
    cdf = torch.cumsum(probabilities, dim=-1)
    choice = (cdf <= u[:, None]).sum(dim=-1)
    return choice.clamp(max=probabilities.shape[-1] - 1)


def _genotype_prior_from_eq(eq, log_uh, inbreeding):
    return log_genotype_prior_dosage(_dosage_from_eq(eq), log_uh, inbreeding=inbreeding)


# ---------------------------------------------------------------------------
# read terms
# ---------------------------------------------------------------------------


def _rows_log_reads(lr_t, problem, genotype, mask=None):
    """sum over the (masked) positions of log P(read r at j | allele
    g[b, p, j]): [B, R, p].  ``lr_t`` is the problems' log reads as [S,
    NB, R, A], ``problem`` [B] each chain's problem."""
    B, p, nb = genotype.shape
    pos = torch.arange(nb, device=genotype.device)
    lr_g = lr_t[problem[:, None, None], pos[None, :, None], :, genotype.transpose(1, 2)]
    if mask is not None:  # [B, nb, p, R]
        lr_g = torch.where(mask[:, :, None, None], lr_g, 0.0)
    return lr_g.sum(dim=1).transpose(1, 2)


def rows_per_chunk(ploidy, n_reads, n_base, device):
    """How many chain-rungs one ``interval_step`` or ``initial_state``
    call may take at once.

    Their largest tensors are, per row, the [K, R, p] f64 read sums of
    every option (K = p(p - 1) dosage options; four live at once: the
    moved interval sums, their sum with the outside sums and
    logsumexp's two) and the [nb, p, R] f64 gathered log reads with
    their masked copy: reckoned against ``memory_budget``.  At ploidy
    16 and 1024 reads one row needs about 128 MB, so a block of a few
    hundred chains does not fit the card in one piece.
    """
    K = ploidy * (ploidy - 1)
    per_row = 8 * n_reads * ploidy * (4 * K + 2 * n_base)
    return max(1, memory_budget(device) // per_row)


def _row_chunks(fn, max_rows, rows, *shared):
    """``fn(*rows, *shared)`` over slices of at most ``max_rows`` of the
    batch rows (``rows``: tensors [B, ...] or None), the results joined.
    Every sub-step is independent per row, so the result does not depend
    on ``max_rows``."""
    B = rows[0].shape[0]
    if max_rows is None or max_rows >= B:
        return fn(*rows, *shared)
    parts = [
        fn(*(None if x is None else x[lo : lo + max_rows] for x in rows), *shared)
        for lo in range(0, B, max_rows)
    ]
    return tuple(torch.cat(x) for x in zip(*parts))


def initial_state(lr_t, problem, counts_b, genotype, max_rows=None):
    """(rh [B, R, p], llk [B]) of genotype [B, p, nb], ``max_rows`` rows
    at a time."""
    return _row_chunks(
        lambda problem, counts_b, genotype: _initial_state(lr_t, problem, counts_b, genotype),
        max_rows, (problem, counts_b, genotype),
    )


def _initial_state(lr_t, problem, counts_b, genotype):
    log_p = math.log(genotype.shape[1])
    rh = _rows_log_reads(lr_t, problem, genotype)
    llk = (counts_b * (torch.logsumexp(rh, dim=-1) - log_p)).sum(-1)
    return rh, llk


# ---------------------------------------------------------------------------
# mutation compound step (reference assemble/mutation.py)
# ---------------------------------------------------------------------------


def mutation_sweep(genotype, rh, llk, lr_t, problem, counts_b, n_alleles_b,
                   log_uh, temp, inbreeding, order, u):
    """MH-within-Gibbs sweep over every (haplotype, position) site.

    Reference ``mutation.compound_step`` + ``base_step``
    (mutation.py:14-246).  Chain b visits site ``order[b, s]`` (a
    flattened h * nb + j) at its s-th step and draws from ``u[b, s]``.
    ``rh`` is updated by a rank-1 step per site.  ``inbreeding`` None
    leaves the prior out; else it and ``log_uh`` are [B].  Returns new
    (genotype, rh, llk).
    """
    genotype, rh = genotype.clone(), rh.clone()
    B, p, nb = genotype.shape
    dev = genotype.device
    A = lr_t.shape[-1]
    log_p = math.log(p)
    bi = torch.arange(B, device=dev)
    ar_a = torch.arange(A, device=dev)
    ar_p = torch.arange(p, device=dev)
    ar_nb = torch.arange(nb, device=dev)
    sites_h, sites_j = order // nb, order % nb
    for s in range(order.shape[1]):
        h, j = sites_h[:, s], sites_j[:, s]
        lr_j = lr_t[problem, j]  # [B, R, A]
        cur = genotype[bi, h, j]
        base = rh[bi, :, h] - lr_j[bi, :, cur]  # [B, R]
        keep = ar_p[None, :] != h[:, None]  # [B, p]
        rest = torch.logsumexp(torch.where(keep[:, None, :], rh, _NEG), dim=-1)
        cand = torch.logaddexp(rest[..., None], base[..., None] + lr_j)
        llks_a = (counts_b[:, :, None] * (cand - log_p)).sum(1)

        # proposal ratio from haplotype copy counts (mutation.py:84-139)
        row = genotype[bi, h]  # [B, nb]
        other = (genotype != row[:, None, :]) & (ar_nb[None, :] != j[:, None])[:, None, :]
        eq_except = ~torch.any(other, dim=-1)  # [B, p] rows equal to h outside j
        same = keep & eq_except
        col = genotype[bi, :, j]  # [B, p]
        col_a = col[:, None, :] == ar_a[None, :, None]  # [B, A, p]
        count_cur = 1 + (same & (col == cur[:, None])).sum(dim=-1)
        counts_a = 1 + (same[:, None, :] & col_a).sum(dim=-1)
        lratio = torch.log(counts_a.to(_F64)) - torch.log(count_cur.to(_F64))[:, None]

        score = llks_a - llk[:, None]
        if inbreeding is not None:
            eq_full = _row_eq(genotype)
            lprior = _genotype_prior_from_eq(eq_full, log_uh, inbreeding)
            # candidate equality: only row and column h change
            is_h = ar_p[None, :] == h[:, None]  # [B, p]
            eq_h_a = eq_except[:, None, :] & col_a | is_h[:, None, :]
            eq_a = torch.where(is_h[:, None, :, None], eq_h_a[:, :, None, :], eq_full[:, None])
            eq_a = torch.where(is_h[:, None, None, :], eq_h_a[:, :, :, None], eq_a)
            lprior_a = _genotype_prior_from_eq(eq_a, log_uh[:, None], inbreeding[:, None])
            score = score + (lprior_a - lprior[:, None])

        mh = score * temp[:, None] + lratio
        # n_alleles == 1 marks a homozygote-fixed position: no proposals
        # at all (mcmc.py:168-199)
        n_j = n_alleles_b[bi, j][:, None]
        valid = (ar_a[None, :] < n_j) & (ar_a[None, :] != cur[:, None]) & (n_j > 1)
        n_options = valid.sum(dim=-1).clamp(min=1).to(_F64)
        log_accept = torch.where(valid, torch.clamp(mh, max=0.0), _NEG)
        probs = torch.where(
            valid, torch.exp(log_accept - torch.log(n_options)[:, None]), 0.0
        )
        stay = 1.0 - probs.sum(dim=-1, keepdim=True)
        probs = torch.where(ar_a[None, :] == cur[:, None], stay, probs)
        choice = _inverse_cdf_choice(probs, u[:, s])

        genotype[bi, h, j] = choice
        rh[bi, :, h] = base + lr_j[bi, :, choice]
        llk = llks_a[bi, choice]
    return genotype, rh, llk


# ---------------------------------------------------------------------------
# structural compound step (reference assemble/structural.py)
# ---------------------------------------------------------------------------


def interval_step(genotype, rh, llk, mask, lr_t, problem, counts_b, log_uh,
                  temp, inbreeding, step_type, u, max_rows=None):
    """One masked-enumeration structural MH step per chain on its interval
    ``mask`` [B, nb] (all False: no move), ``max_rows`` chains at a time
    (``rows_per_chunk``).

    Reference ``interval_step`` (structural.py:433-587); ``step_type`` 0
    is recombination, 1 the dosage swap.  ``u`` [B] is each chain's draw.
    """
    rows = (genotype, rh, llk, mask, problem, counts_b, log_uh, temp, inbreeding, u)
    return _row_chunks(
        lambda g, rh, llk, mask, problem, counts_b, log_uh, temp, inbreeding, u:
        _interval_step(g, rh, llk, mask, lr_t, problem, counts_b, log_uh, temp,
                       inbreeding, step_type, u),
        max_rows, rows,
    )


def _interval_step(genotype, rh, llk, mask, lr_t, problem, counts_b, log_uh,
                   temp, inbreeding, step_type, u):
    B, p, nb = genotype.shape
    log_p = math.log(p)
    bi = torch.arange(B, device=genotype.device)
    ar_p = torch.arange(p, device=genotype.device)

    labels = segment_labels(genotype, mask)
    if step_type == 0:
        options, valid = recombination_options(labels)
        n_return = recombination_n_options(options)
    else:
        options, valid = dosage_options(labels)
        n_return = dosage_n_options(options)
    n_options = valid.sum(dim=-1)
    K = options.shape[-3]

    # per-read interval partial sums of the current genotype
    rh_int = _rows_log_reads(lr_t, problem, genotype, mask)  # [B, R, p]
    rh_out = rh - rh_int
    srcs = options[..., 0]  # [B, K, p] segment-source row per option
    R = rh.shape[1]
    moved = torch.gather(
        rh_int[:, None].expand(B, K, R, p), 3, srcs[:, :, None, :].expand(B, K, R, p)
    )
    read_log = torch.logsumexp(rh_out[:, None] + moved, dim=-1) - log_p  # [B, K, R]
    llk_opts = (read_log * counts_b[:, None, :]).sum(-1)

    score = llk_opts - llk[:, None]
    if inbreeding is not None:
        lprior = _genotype_prior_from_eq(_row_eq(genotype), log_uh, inbreeding)
        eq_opts = torch.all(options[..., :, None, :] == options[..., None, :, :], dim=-1)
        lprior_opts = _genotype_prior_from_eq(eq_opts, log_uh[:, None], inbreeding[:, None])
        score = score + (lprior_opts - lprior[:, None])

    log_n = torch.log(n_options.clamp(min=1).to(_F64))[:, None]
    lproposal = log_n - torch.log(n_return.clamp(min=1).to(_F64))
    mh = score * temp[:, None] + lproposal
    log_accept = torch.where(valid, torch.clamp(mh, max=0.0), _NEG) - log_n
    probs = torch.where(valid, torch.exp(log_accept), 0.0)
    probs = torch.cat([probs, 1.0 - probs.sum(-1, keepdim=True)], dim=-1)
    choice = _inverse_cdf_choice(probs, u)
    accepted = choice < K
    safe = choice.clamp(max=K - 1)

    src = torch.where(accepted[:, None], srcs[bi, safe], ar_p[None, :])  # [B, p]
    moved_rows = torch.gather(genotype, 1, src[:, :, None].expand(B, p, nb))
    genotype = torch.where(mask[:, None, :], moved_rows, genotype)
    rh = rh_out + torch.gather(rh_int, 2, src[:, None, :].expand(B, R, p))
    llk = torch.where(accepted, llk_opts[bi, safe], llk)
    return genotype, rh, llk


def intervals_from_draws(break_dist, u_breaks, points, order):
    """Each chain's interval partition as (starts, ends) [B, nb].

    Fixed-shape equivalent of reference ``random_breaks``
    (structural.py:22-71): n_breaks ~ ``break_dist`` [B, nb] by inverse
    cdf at ``u_breaks`` [B]; the first n_breaks of ``points`` [B, nb - 1]
    (a permutation of 1..nb-1) are the break points; the unused tail is
    padded with empty (nb, nb) intervals, and the intervals are put in
    the order ``order`` [B, nb] (a permutation of 0..nb-1).
    """
    B, nb = break_dist.shape
    cdf = torch.cumsum(break_dist, dim=-1)
    n_breaks = (cdf <= u_breaks[:, None]).sum(dim=-1)
    ar = torch.arange(nb - 1, device=break_dist.device)
    chosen = torch.where(ar[None, :] < n_breaks[:, None], points, nb)
    chosen = torch.sort(chosen, dim=-1).values
    zero = torch.zeros((B, 1), dtype=chosen.dtype, device=chosen.device)
    starts = torch.cat([zero, chosen], dim=-1).gather(1, order)
    ends = torch.cat([chosen, zero + nb], dim=-1).gather(1, order)
    return starts, ends


def _random_permutations(u):
    """A uniformly random permutation of 0..n-1 per row of u [B, n]; equal
    draws keep their index order (K4 ranks them the same way)."""
    return torch.argsort(u, dim=-1, stable=True)


def structural_sweep(genotype, rh, llk, starts, ends, lr_t, problem, counts_b,
                     log_uh, temp, inbreeding, step_type, u, max_rows=None):
    """Interval steps over each chain's padded interval list
    (structural.py:590-673); ``u`` [B, nb] one draw per interval."""
    pos = torch.arange(genotype.shape[-1], device=genotype.device)
    for i in range(starts.shape[1]):
        mask = (pos[None, :] >= starts[:, i, None]) & (pos[None, :] < ends[:, i, None])
        genotype, rh, llk = interval_step(
            genotype, rh, llk, mask, lr_t, problem, counts_b, log_uh, temp,
            inbreeding, step_type, u[:, i], max_rows,
        )
    return genotype, rh, llk


# ---------------------------------------------------------------------------
# tempering (reference assemble/tempering.py)
# ---------------------------------------------------------------------------


def chain_swaps(genotype, rh, llk, temperatures, log_uh, inbreeding, u):
    """Neighbour-rung state swaps (Sambridge 2014 eq. 11), warmest pair
    first; tempering.py:10-151.

    The state is [N, T, ...] over T rungs of ascending inverse
    temperature; ``u`` [N, T - 1] is each pair's draw.  The cached rh
    travels with its genotype (rh is a function of the genotype, so
    exchanging the copies is exact).  Updates the state in place.
    """
    for t in range(1, genotype.shape[1]):
        post = llk[:, t - 1 : t + 1]
        if inbreeding is not None:
            post = post + _genotype_prior_from_eq(
                _row_eq(genotype[:, t - 1 : t + 1]), log_uh[:, None], inbreeding[:, None]
            )
        post_j, post_i = post[:, 0], post[:, 1]
        acceptance = torch.clamp(
            torch.exp((post_j - post_i) * temperatures[t]
                      + (post_i - post_j) * temperatures[t - 1]),
            max=1.0,
        )
        swap = acceptance >= u[:, t - 1]
        for x in (genotype, rh, llk):
            pair = x[:, t - 1 : t + 1]
            flat = swap.view((-1,) + (1,) * (pair.dim() - 1))
            pair.copy_(torch.where(flat, pair.flip(1), pair))


# ---------------------------------------------------------------------------
# full sampler (reference assemble/mcmc.py:_denovo_assembler)
# ---------------------------------------------------------------------------


def step_draw_offsets(ploidy, n_base):
    """Offsets of each sub-step's uniforms in one chain-rung's draws of a
    step, and their count ``D``."""
    sites = ploidy * n_base
    structural = 3 * n_base + 1  # do, n_breaks, nb - 1 points, nb orders, nb steps
    out = dict(order=0, sites=sites, recomb=2 * sites)
    out["partial"] = out["recomb"] + structural
    out["full"] = out["partial"] + structural
    out["swap"] = out["full"] + 2
    out["D"] = out["swap"] + 1
    return out


def denovo_sampler(
    seed,
    row_offset,
    initial,
    log_reads,
    read_counts,
    n_alleles,
    break_dist,
    temperatures,
    *,
    n_steps,
    burn=0,
    inbreeding=None,
    recombination_step_probability=0.5,
    partial_dosage_step_probability=0.5,
    dosage_step_probability=1.0,
    cuda_graph=None,
):
    """Run batched-chain de novo assembly MCMC on ``log_reads.device``.

    Parameters
    ----------
    seed : the draws' seed; row_offset : the global index of this call's
        row 0 in the whole block.  Draw j of a step for row b (rows
        ordered (problem, chain, rung)) is ``keyed_uniforms`` draw j of
        row row_offset + b, in the layout of ``step_draw_offsets``
    initial : int[S, C, ploidy, nb] initial genotypes of C chains per problem
    log_reads : f64[S, R, nb, A] log read probabilities (gaps 0, zeros
        clamped to ``ops.likelihood.MIN_LOG``)
    read_counts : f64[S, R]
    n_alleles : int[S, nb]; fixed positions carry 1
    break_dist : f64[S, nb] distribution over break counts
    temperatures : ascending inverse temperatures, the last 1.0
    inbreeding : None (no prior) or f64[S] (the prior; 0 selects its flat
        branch)
    cuda_graph : replay one captured CUDA graph per step after the first
        (default: on a CUDA device).  A step is thousands of small
        launches, which a graph issues without the host.

    Returns
    -------
    genotypes : int8[S, C, n_steps - burn, ploidy, nb] (cold rung)
    llks : f64[S, C, n_steps - burn]
    """
    dev = log_reads.device
    S, C, ploidy, nb = initial.shape
    temps = torch.as_tensor(np.asarray(temperatures, float), dtype=_F64, device=dev)
    T = temps.shape[0]
    N, B = S * C, S * C * T
    lr_t = log_reads.to(_F64).permute(0, 2, 1, 3).contiguous()  # [S, nb, R, A]
    problem = torch.arange(S, device=dev).repeat_interleave(C * T)
    counts_b = read_counts.to(_F64)[problem]
    n_alleles_b = n_alleles.to(dev, torch.long)[problem]
    bd_b = break_dist.to(_F64)[problem]
    log_uh = torch.log(n_alleles.to(dev, _F64)).sum(dim=-1)[problem]
    ib = None if inbreeding is None else inbreeding.to(dev, _F64)[problem]
    temp_b = temps.repeat(N)

    g = initial.to(dev, torch.long)[:, :, None].expand(S, C, T, ploidy, nb)
    g = g.reshape(B, ploidy, nb).clone()  # the state, updated in place
    R = lr_t.shape[2]
    max_rows = rows_per_chunk(ploidy, R, nb, dev)
    rh, llk = initial_state(lr_t, problem, counts_b, g, max_rows)

    lay = step_draw_offsets(ploidy, nb)
    D, sites = lay["D"], ploidy * nb
    full = torch.ones((B, nb), dtype=torch.bool, device=dev)
    kept = n_steps - burn
    trace_g = torch.empty((max(kept, 0), N, ploidy, nb), dtype=torch.int8, device=dev)
    trace_llk = torch.empty((max(kept, 0), N), dtype=_F64, device=dev)

    def structural(u, g, rh, llk, p_do, step_type):
        do = u[:, 0] <= p_do
        starts, ends = intervals_from_draws(
            bd_b, u[:, 1], _random_permutations(u[:, 2 : nb + 1]) + 1,
            _random_permutations(u[:, nb + 1 : 2 * nb + 1]),
        )
        ends = torch.where(do[:, None], ends, starts)  # skipped: empty intervals
        return structural_sweep(
            g, rh, llk, starts, ends, lr_t, problem, counts_b, log_uh, temp_b,
            ib, step_type, u[:, 2 * nb + 1 :], max_rows,
        )

    u = torch.empty((B, D), dtype=_F64, device=dev)
    rows = row_offset + torch.arange(B, device=dev)

    def run_step():
        """One compound step of every rung from the draws in ``u``, its
        result written back into (g, rh, llk)."""
        order = _random_permutations(u[:, :sites])
        g1, rh1, llk1 = mutation_sweep(
            g, rh, llk, lr_t, problem, counts_b, n_alleles_b, log_uh, temp_b,
            ib, order, u[:, lay["sites"] : lay["recomb"]],
        )
        g1, rh1, llk1 = structural(
            u[:, lay["recomb"] : lay["partial"]], g1, rh1, llk1,
            recombination_step_probability, 0,
        )
        g1, rh1, llk1 = structural(
            u[:, lay["partial"] : lay["full"]], g1, rh1, llk1,
            partial_dosage_step_probability, 1,
        )
        do = u[:, lay["full"]] <= dosage_step_probability
        g1, rh1, llk1 = interval_step(
            g1, rh1, llk1, full & do[:, None], lr_t, problem, counts_b, log_uh,
            temp_b, ib, 1, u[:, lay["full"] + 1], max_rows,
        )
        g.copy_(g1)
        rh.copy_(rh1)
        llk.copy_(llk1)
        if T > 1:
            view = lambda x: x.view((N, T) + x.shape[1:])  # noqa: E731
            chain_swaps(
                view(g), view(rh), view(llk), temps,
                None if ib is None else view(log_uh)[:, 0],
                None if ib is None else view(ib)[:, 0],
                view(u[:, lay["swap"]])[:, 1:],
            )

    if cuda_graph is None:
        cuda_graph = dev.type == "cuda"
    graph = None
    for step in range(n_steps):
        # outside the graph: a capture would replay its step's draws
        keyed_uniforms(seed, rows, step, D, _F64, out=u)
        if graph is not None:
            graph.replay()
        elif cuda_graph:
            # the first step runs on a side stream (it also warms the
            # caches a capture may not fill); later steps replay its capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run_step()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run_step()
        else:
            run_step()
        if step >= burn:
            trace_g[step - burn] = g.view(N, T, ploidy, nb)[:, -1]
            trace_llk[step - burn] = llk.view(N, T)[:, -1]
    genotypes = trace_g.view(-1, S, C, ploidy, nb).permute(1, 2, 0, 3, 4)
    llks = trace_llk.view(-1, S, C).permute(1, 2, 0)
    return genotypes, llks


# ---------------------------------------------------------------------------
# per-position homozygosity screen (reference mcmc.py:494-541)
# ---------------------------------------------------------------------------


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
