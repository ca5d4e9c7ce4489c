"""Pedigree-informed MCMC: the trio transition model and the joint sampler.

Port of ``mchap_tpu/ops/pedigree_mcmc.py`` (reference
``mchap/pedigree/prior.py`` and ``mcmc.py``) in PyTorch, f64 on every
device.  The reference's irregular gamete-dosage iterator becomes a
masked enumeration over static composition tables, so the trio pmf is a
few masked gathers and a logsumexp, batched over any leading dimensions.

``pedigree_sampler`` is the general joint sampler, batched over (locus,
chain): Gibbs or Metropolis-Hastings slot updates, the parental-pair
allele swap, and a chromatic schedule (samples of one color lie outside
each other's Markov blankets and update as one batch).  It serves what
the CUDA kernel K3 (``ops/cuda_pedigree.py``) does not: double reduction
(lambda > 0), Metropolis-Hastings steps and two-parent samples whose
gamete ploidies do not sum to their ploidy.  Slots are visited in
systematic order 0..P-1 (the JAX package draws a random order; both are
valid Gibbs scans, gated against exact enumeration).  Draws come from an
explicit ``torch.Generator``.

Genotypes are fixed-width int rows [..., max_ploidy] padded with -1 for
lower-ploidy samples, as in the reference.
"""

import itertools
import math

import numpy as np
import torch

NEG = -1e300  # finite stand-in for log(0): -inf would turn MH ratios into nan
TINY = 1e-300

_COMB_LUT = np.zeros((17, 17))
for _n in range(17):
    for _k in range(_n + 1):
        _COMB_LUT[_n, _k] = float(math.comb(_n, _k))


def composition_tables(max_ploidy):
    """Static tables of all dosage vectors with a given sum.

    Returns (tables i[max_ploidy+1, K_max, max_ploidy], valid
    b[max_ploidy+1, K_max]): tables[tau] enumerates every vector of
    non-negative ints over max_ploidy slots summing to tau (the
    reference's increment_dosage walk, prior.py:230-294).
    """
    all_tables = []
    for tau in range(max_ploidy + 1):
        rows = [
            c
            for c in itertools.product(range(tau + 1), repeat=max_ploidy)
            if sum(c) == tau
        ]
        all_tables.append(np.array(rows, dtype=np.int32).reshape(-1, max_ploidy))
    k_max = max(len(t) for t in all_tables)
    tables = np.zeros((max_ploidy + 1, k_max, max_ploidy), np.int32)
    valid = np.zeros((max_ploidy + 1, k_max), bool)
    for tau, t in enumerate(all_tables):
        tables[tau, : len(t)] = t
        valid[tau, : len(t)] = True
    return tables, valid


# ---------------------------------------------------------------------------
# dosage helpers on padded genotype rows (reference prior.py:7-92)
# ---------------------------------------------------------------------------


def _first_and_counts(progeny):
    called = progeny >= 0
    eq = (
        (progeny[..., :, None] == progeny[..., None, :])
        & called[..., None, :]
        & called[..., :, None]
    )
    maxp = progeny.shape[-1]
    tri = torch.tril(torch.ones((maxp, maxp), dtype=torch.bool, device=progeny.device), -1)
    first = ~torch.any(eq & tri, dim=-1) & called
    return first, eq.sum(-1)


def padded_dosage(genotype):
    """Allelic dosage credited to first occurrence; padding (<0) -> 0."""
    first, counts = _first_and_counts(genotype)
    return torch.where(first, counts, 0)


def parental_copies(parent, progeny):
    """Count of each progeny allele within the parent, credited to the
    first progeny slot holding that allele (prior.py:38-70)."""
    match = (parent[..., None, :] == progeny[..., :, None]) & (parent[..., None, :] >= 0)
    counts = match.sum(-1)
    first, _ = _first_and_counts(progeny)
    return torch.where(first, counts, 0)


def _lut(comb_lut, n, k):
    """comb_lut[n, k] with numpy's index semantics (a negative k counts
    from the end, where the table holds 0)."""
    size = comb_lut.shape[-1]
    return comb_lut[n.clamp(0, size - 1), torch.remainder(k, size)]


def _ln_perms(dosage, dtype):
    d = dosage.to(dtype)
    return torch.lgamma(d.sum(-1) + 1.0) - torch.lgamma(d + 1.0).sum(-1)


def _log_unknown_dosage_prior(dosage, dlf):
    """Multinomial prior of a dosage of unknown origin (prior.py:121-144)."""
    d = dosage.to(dlf.dtype)
    return _ln_perms(dosage, dlf.dtype) + torch.where(dosage > 0, d * dlf, 0.0).sum(-1)


def _gamete_log_pmf(gametes, tau, parent_dose, parent_ploidy, lam, comb_lut):
    """log pmf of gamete dosages [..., K, maxp] drawn from a parent dosage
    [..., maxp]; tau, parent_ploidy, lam broadcast over [...].  Reference
    prior.py:329-373, with the double-reduction mixture."""
    dtype = comb_lut.dtype
    perms = _lut(comb_lut, parent_dose[..., None, :], gametes).prod(-1)  # [..., K]
    denom = torch.clamp(_lut(comb_lut, parent_ploidy, tau), min=1.0)[..., None]
    lam = lam[..., None]
    prob = (perms / denom) * (1.0 - lam)
    # double reduction: the gamete is 2 copies of one allele (tau == 2 only)
    is_dr = (gametes.max(-1).values == 2) & (gametes.sum(-1) == 2)
    dr_allele = torch.argmax(gametes, dim=-1)
    dr_perms = torch.where(
        is_dr, torch.gather(parent_dose, -1, dr_allele), 0
    ).to(dtype)
    ploidy = torch.clamp(parent_ploidy, min=1).to(dtype)[..., None]
    prob = prob + torch.where(lam > 0.0, dr_perms / ploidy * lam, 0.0)
    return torch.where(prob > 0.0, torch.log(torch.clamp(prob, min=TINY)), NEG)


def trio_log_pmf(progeny, parent_p, parent_q, ploidy_p, ploidy_q, tau_p, tau_q,
                 lam_p, lam_q, err_p, err_q, log_freqs, tables, tables_valid,
                 comb_lut):
    """Log probability of a progeny genotype given two parents.

    Batched equivalent of reference ``trio_log_pmf`` (prior.py:484-722):
    the four-way error mixture (A both parents correct, B only p, C only
    q, D neither) with gamete splits enumerated over the static
    composition tables.  Genotype rows are [..., maxp]; ploidy, tau,
    lambda and error broadcast over [...]; ``log_freqs`` is [H] or
    [..., H]; ``tables``/``tables_valid``/``comb_lut`` come from
    ``composition_tables`` and ``_COMB_LUT`` as tensors (f64 LUT).
    Returns [...].
    """
    dtype = comb_lut.dtype
    device = progeny.device
    batch = torch.Size(np.broadcast_shapes(
        tuple(progeny.shape[:-1]), tuple(parent_p.shape[:-1]), tuple(parent_q.shape[:-1]),
        *(tuple(np.shape(x)) for x in
          (ploidy_p, ploidy_q, tau_p, tau_q, lam_p, lam_q, err_p, err_q)),
        tuple(log_freqs.shape[:-1]),
    ))
    maxp = progeny.shape[-1]

    def full(x, dt):
        return torch.as_tensor(x, dtype=dt, device=device).expand(batch)

    progeny = progeny.expand(batch + (maxp,))
    parent_p = parent_p.expand(batch + (maxp,))
    parent_q = parent_q.expand(batch + (maxp,))
    ploidy_p, ploidy_q, tau_p, tau_q = (
        full(x, torch.long) for x in (ploidy_p, ploidy_q, tau_p, tau_q)
    )
    lam_p, lam_q, err_p, err_q = (full(x, dtype) for x in (lam_p, lam_q, err_p, err_q))

    dosage = padded_dosage(progeny)
    lf = log_freqs.expand(batch + log_freqs.shape[-1:])
    dlf = torch.where(progeny >= 0, torch.gather(lf, -1, progeny.clamp(min=0)), 0.0)
    dosage_p = torch.where(ploidy_p[..., None] > 0, parental_copies(parent_p, progeny), 0)
    dosage_q = torch.where(ploidy_q[..., None] > 0, parental_copies(parent_q, progeny), 0)
    constraint_p = torch.minimum(dosage, dosage_p)
    constraint_q = torch.minimum(dosage, dosage_q)
    # double-reduction constraint adjustment (prior.py:583-600)
    constraint_p = torch.where(
        (lam_p[..., None] > 0.0) & (dosage >= 2) & (constraint_p == 1), 2, constraint_p
    )
    constraint_q = torch.where(
        (lam_q[..., None] > 0.0) & (dosage >= 2) & (constraint_q == 1), 2, constraint_q
    )

    # clone edges (tau == 0) force the error branch (prior.py:556-557)
    err_p = torch.where(tau_p == 0, 1.0, err_p)
    err_q = torch.where(tau_q == 0, 1.0, err_q)
    lerr_p = torch.log(torch.clamp(err_p, min=TINY))
    lerr_q = torch.log(torch.clamp(err_q, min=TINY))
    lcor_p = torch.where(err_p < 1.0, torch.log(torch.clamp(1.0 - err_p, min=TINY)), NEG)
    lcor_q = torch.where(err_q < 1.0, torch.log(torch.clamp(1.0 - err_q, min=TINY)), NEG)

    valid_p = (constraint_p.sum(-1) >= tau_p) & (tau_p > 0) & (err_p < 1.0)
    valid_q = (constraint_q.sum(-1) >= tau_q) & (tau_q > 0) & (err_q < 1.0)
    vp, vq = valid_p[..., None], valid_q[..., None]

    # enumeration from parent p's side: gametes summing to tau_p
    gp = tables[tau_p]  # [..., K, maxp]
    gp_ok = tables_valid[tau_p] & torch.all(gp <= constraint_p[..., None, :], dim=-1)
    gq_of_p = dosage[..., None, :] - gp
    lpmf_p = _gamete_log_pmf(gp, tau_p, dosage_p, ploidy_p, lam_p, comb_lut)
    lpmf_q_of_p = _gamete_log_pmf(gq_of_p, tau_q, dosage_q, ploidy_q, lam_q, comb_lut)
    unknown_q = _log_unknown_dosage_prior(gq_of_p, dlf[..., None, :])
    a_terms = torch.where(
        gp_ok & vp & vq,
        lpmf_p + lcor_p[..., None] + lpmf_q_of_p + lcor_q[..., None], NEG,
    )
    b_terms = torch.where(
        gp_ok & vp, lpmf_p + lcor_p[..., None] + unknown_q + lerr_q[..., None], NEG
    )

    # enumeration from parent q's side: gametes summing to tau_q
    gq = tables[tau_q]
    gq_ok = tables_valid[tau_q] & torch.all(gq <= constraint_q[..., None, :], dim=-1)
    gp_of_q = dosage[..., None, :] - gq
    lpmf_q = _gamete_log_pmf(gq, tau_q, dosage_q, ploidy_q, lam_q, comb_lut)
    unknown_p = _log_unknown_dosage_prior(gp_of_q, dlf[..., None, :])
    c_terms = torch.where(
        gq_ok & vq, lpmf_q + lcor_q[..., None] + unknown_p + lerr_p[..., None], NEG
    )

    # D: both parents in error
    d_term = _log_unknown_dosage_prior(dosage, dlf) + lerr_p + lerr_q
    stacked = torch.cat([a_terms, b_terms, c_terms, d_term[..., None]], dim=-1)
    return torch.logsumexp(stacked, dim=-1)


# ---------------------------------------------------------------------------
# pedigree structure (host, numpy)
# ---------------------------------------------------------------------------


def markov_blankets(sample_parents):
    """Each sample's Markov blanket in the pedigree's moral graph: its
    parents, its children and its children's other parents (a set each;
    symmetric)."""
    sample_parents = np.asarray(sample_parents)
    n = len(sample_parents)
    adj = [set() for _ in range(n)]
    for i in range(n):
        p, q = sample_parents[i]
        for r in (int(p), int(q)):
            if r >= 0:
                adj[i].add(r)
                adj[r].add(i)
        if p >= 0 and q >= 0:
            adj[int(p)].add(int(q))
            adj[int(q)].add(int(p))
    return adj


def chromatic_colors(sample_parents):
    """Greedy coloring of the pedigree's moral graph.

    Two samples share a color only if neither is in the other's Markov
    blanket (parent, child or co-parent); a color's conditionals are then
    independent given the rest, and the color updates as one batch.
    """
    adj = markov_blankets(sample_parents)
    n = len(adj)
    colors = []
    for i in sorted(range(n), key=lambda x: -len(adj[x])):
        for group in colors:
            if adj[i].isdisjoint(group):
                group.add(i)
                break
        else:
            colors.append({i})
    return [sorted(g) for g in colors]


def sample_children_matrix(sample_parents):
    """Children of each sample, padded with -1 (mcmc.py:415-457)."""
    sample_parents = np.asarray(sample_parents)
    n_samples = len(sample_parents)
    children = [[] for _ in range(n_samples)]
    for i in range(n_samples):
        seen = set()
        for j in range(2):
            p = sample_parents[i, j]
            if p >= 0 and p not in seen:
                children[p].append(i)
                seen.add(p)
    max_children = max(max((len(c) for c in children), default=0), 1)
    out = np.full((n_samples, max_children), -1, np.int32)
    for i, c in enumerate(children):
        out[i, : len(c)] = c
    return out


def parental_pair_markov_blankets(sample_parents, sample_children):
    """Unique parental pairs and their padded blankets (mcmc.py:460-500).

    A blanket lists each member once: the pair and the children of
    either parent.
    """
    sample_parents = np.asarray(sample_parents)
    sample_children = np.asarray(sample_children)
    n_samples = len(sample_parents)
    pairs = {}
    for i in range(n_samples):
        p, q = sample_parents[i]
        if p > q:
            p, q = q, p
        if p < 0 or q < 0 or (p, q) in pairs:
            continue
        in_blanket = np.zeros(n_samples, bool)
        in_blanket[[p, q]] = True
        for c in sample_children[p]:
            if c >= 0:
                in_blanket[c] = True
        for c in sample_children[q]:
            if c >= 0:
                in_blanket[c] = True
        pairs[(p, q)] = np.where(in_blanket)[0]
    if not pairs:
        return np.zeros((0, 2), np.int32), np.zeros((0, 1), np.int32)
    max_size = max(len(b) for b in pairs.values())
    parental_pairs = np.zeros((len(pairs), 2), np.int32)
    blankets = np.full((len(pairs), max_size), -1, np.int32)
    for i, ((p, q), blanket) in enumerate(pairs.items()):
        parental_pairs[i] = (p, q)
        blankets[i, : len(blanket)] = blanket
    return parental_pairs, blankets


# ---------------------------------------------------------------------------
# host-side validation (reference pedigree/validation.py), vectorized numpy
# ---------------------------------------------------------------------------


def _np_dosage_and_copies(progeny, parent):
    """(dosage, parental_copies) for batches of padded genotype rows."""
    called = progeny >= 0
    eq = (progeny[..., :, None] == progeny[..., None, :]) & called[..., None, :] & called[..., :, None]
    maxp = progeny.shape[-1]
    tri = np.tril(np.ones((maxp, maxp), bool), k=-1)
    first = ~np.any(eq & tri, axis=-1) & called
    dosage = np.where(first, eq.sum(-1), 0)
    match = (parent[..., None, :] == progeny[..., :, None]) & (parent[..., None, :] >= 0)
    copies = np.where(first, match.sum(-1), 0)
    return dosage, copies


def _adjust_dr(constraint, dosage, lam):
    return np.where((lam[..., None] > 0) & (dosage >= 2) & (constraint == 1), 2, constraint)


def duo_valid(progeny, parent, tau, lam):
    """Batched: progeny can derive one gamete from parent (validation.py:12-31)."""
    dosage, copies = _np_dosage_and_copies(progeny, parent)
    constraint = _adjust_dr(np.minimum(dosage, copies), dosage, np.asarray(lam))
    return constraint.sum(-1) >= tau


def trio_valid(progeny, parent_p, parent_q, tau_p, tau_q, lam_p, lam_q):
    """Batched: a valid gamete split exists (validation.py:34-99)."""
    progeny = np.asarray(progeny)
    maxp = progeny.shape[-1]
    dosage, copies_p = _np_dosage_and_copies(progeny, parent_p)
    _, copies_q = _np_dosage_and_copies(progeny, parent_q)
    cp = _adjust_dr(np.minimum(dosage, copies_p), dosage, np.asarray(lam_p))
    cq = _adjust_dr(np.minimum(dosage, copies_q), dosage, np.asarray(lam_q))
    tables, valid = composition_tables(maxp)
    tau_p = np.asarray(tau_p)
    t = tables[tau_p]  # [..., K, maxp]
    tv = valid[tau_p]  # [..., K]
    ok = (
        tv
        & np.all(t <= cp[..., None, :], axis=-1)
        & np.all((dosage[..., None, :] - t) >= 0, axis=-1)
        & np.all((dosage[..., None, :] - t) <= cq[..., None, :], axis=-1)
    )
    base = (cp.sum(-1) >= tau_p) & (cq.sum(-1) >= np.asarray(tau_q))
    return base & np.any(ok, axis=-1)


# ---------------------------------------------------------------------------
# the joint sampler, batched over (locus, chain)
# ---------------------------------------------------------------------------


class Pedigree:
    """Static pedigree tables for ``pedigree_sampler`` (host numpy plus
    the device tensors the trio pmf reads)."""

    def __init__(self, sample_ploidy, sample_parents, gamete_tau,
                 gamete_lambda, gamete_error, device):
        self.ploidy = np.asarray(sample_ploidy, np.int64)
        self.parents = np.asarray(sample_parents, np.int64)
        self.tau = np.asarray(gamete_tau, np.int64)
        self.lam = np.asarray(gamete_lambda, float)
        self.err = np.asarray(gamete_error, float)
        self.n_samples = len(self.ploidy)
        self.max_ploidy = int(self.ploidy.max())
        self.device = device
        self.colors = chromatic_colors(self.parents)
        self.children = sample_children_matrix(self.parents)
        self.pairs, self.blankets = parental_pair_markov_blankets(
            self.parents, self.children
        )
        tables, valid = composition_tables(self.max_ploidy)
        self.tables = torch.as_tensor(tables, dtype=torch.long, device=device)
        self.tables_valid = torch.as_tensor(valid, device=device)
        self.comb_lut = torch.as_tensor(_COMB_LUT, device=device)
        # per-sample trio arguments with missing parents made explicit:
        # ploidy 0 and error 1 (the error branch only)
        has = self.parents >= 0
        self.parent_ploidy = np.where(has, self.ploidy[self.parents.clip(0)], 0)
        self.trio_err = np.where(has, self.err, 1.0)

    def members(self, ids):
        """Static trio arguments of the samples ``ids`` (i[...], -1 =
        padding), for ``trio_sum``."""
        ids = np.asarray(ids)
        idx = ids.clip(0)
        dev = self.device

        def t(x, dt):
            return torch.as_tensor(x[idx], dtype=dt, device=dev)

        par = np.where(ids[..., None] >= 0, self.parents[idx], -1)
        return dict(
            ids=torch.as_tensor(ids, dtype=torch.long, device=dev),
            par=torch.as_tensor(par, dtype=torch.long, device=dev),
            args=(
                t(self.parent_ploidy[:, 0], torch.long), t(self.parent_ploidy[:, 1], torch.long),
                t(self.tau[:, 0], torch.long), t(self.tau[:, 1], torch.long),
                t(self.lam[:, 0], torch.float64), t(self.lam[:, 1], torch.float64),
                t(self.trio_err[:, 0], torch.float64), t(self.trio_err[:, 1], torch.float64),
            ),
        )

    def trio_sum(self, members, rows_of, log_freqs):
        """Sum of the trio pmfs of ``members`` (from ``members``) over
        their last axis.

        ``rows_of(ids)`` returns the genotype rows [B, ..., maxp] of the
        samples ``ids`` (i[...], -1 -> a row of -1), broadcast over any
        extra candidate axes; ``log_freqs`` [B, H] is broadcast to the
        batch.  Returns [B, ...].
        """
        ids = members["ids"]
        prog = rows_of(ids)
        rp = rows_of(members["par"][..., 0])
        rq = rows_of(members["par"][..., 1])
        nd = prog.dim() - 1
        lf = log_freqs.reshape(log_freqs.shape[:1] + (1,) * (nd - 1) + log_freqs.shape[1:])
        out = trio_log_pmf(
            prog, rp, rq, *members["args"], lf, self.tables, self.tables_valid,
            self.comb_lut,
        )
        return torch.where(ids >= 0, out, 0.0).sum(-1)


def _rows(g, ids):
    """Genotype rows of samples ``ids`` (i[...]) from g [B, S, maxp];
    id -1 gives a row of -1.  Returns [B, ..., maxp]."""
    rows = g[:, ids.clamp(min=0)]
    return torch.where((ids >= 0)[None, ..., None], rows, -1)


def _sample_llk(rh, counts, rows, ploidy):
    """llk of genotype rows [B, maxp] from rh [B, R, H], counts [B, R]."""
    maxp = rows.shape[-1]
    sub = torch.gather(rh, 2, rows.clamp(min=0)[:, None, :].expand(-1, rh.shape[1], -1))
    mask = torch.arange(maxp, device=rh.device) < ploidy
    read_log = torch.logsumexp(torch.where(mask, sub, NEG), -1) - math.log(ploidy)
    return (counts * read_log).sum(-1)


def pedigree_sampler(gen, initial, rh, counts, log_freqs, n_valid, problem, ped,
                     *, n_steps, step_type=0, swap_parental_alleles=True):
    """Run the joint pedigree sampler for B = len(problem) chains.

    gen : torch.Generator on the tensors' device
    initial : i[B, S, maxp] (-1 pads lower-ploidy samples)
    rh : f64[N, S, R, H] per-problem read x haplotype log-likelihoods;
    counts : f64[N, S, R]; log_freqs : f64[N, H] (padding -inf);
    n_valid : i[N]; problem : i[B] maps each chain to its problem
    ped : ``Pedigree``; step_type : 0 Gibbs, 1 Metropolis-Hastings

    Each compound step updates the colors in order (a color's members as
    one batch, slots 0..P-1), then does one MH allele swap per parental
    pair (mcmc.py:503-655).  Returns the raw slot alleles after each
    step, i64[B, n_steps, S, maxp] (unsorted, as the reference's in-loop
    state).
    """
    device = rh.device
    prob = problem.long()
    rh_c, cnt_c, lf_c = rh[prob], counts[prob], log_freqs[prob]
    nv_c = n_valid.long()[prob]
    B = prob.shape[0]
    S, maxp, H = ped.n_samples, ped.max_ploidy, rh.shape[-1]
    alleles = torch.arange(H, device=device)
    valid = alleles[None, :] < nv_c[:, None]  # [B, H]
    g = initial.long().clone().to(device)
    trace = torch.empty((B, n_steps, S, maxp), dtype=torch.long, device=device)

    color_tabs = []
    for ids in ped.colors:
        kids = ped.children[ids]
        w = int((kids >= 0).sum(1).max(initial=0))
        members = np.concatenate([np.asarray(ids)[:, None], kids[:, :w]], 1)
        color_tabs.append((
            torch.as_tensor(ids, device=device),
            ped.members(members[:, None, :]),
            torch.as_tensor(ped.ploidy[ids], device=device),
        ))
    pairs = ped.pairs if swap_parental_alleles else ped.pairs[:0]

    def slot_update(ids, blanket, ploidy, k):
        n_c = ids.shape[0]
        rows = g[:, ids]  # [B, n_c, maxp]
        rh_s = rh_c[:, ids]  # [B, n_c, R, H]
        slot = torch.arange(maxp, device=device)
        keep = (slot != k) & (slot[None, :] < ploidy[:, None])  # [n_c, maxp]
        sub = torch.gather(
            rh_s, 3, rows.clamp(min=0)[:, :, None, :].expand(-1, -1, rh_s.shape[2], -1)
        )
        rest = torch.logsumexp(torch.where(keep[None, :, None, :], sub, NEG), -1)
        cand = torch.logaddexp(rest[..., None], rh_s)
        llks = (cnt_c[:, ids][..., None] * (
            cand - torch.log(ploidy.double())[None, :, None, None]
        )).sum(2)  # [B, n_c, H]
        options = rows[:, :, None, :].expand(B, n_c, H, maxp).clone()
        options[..., k] = alleles
        member_of = ids[:, None, None]

        def rows_of(x):
            # x: [n_c, 1, W]; rows [B, n_c, H, W, maxp] with the updating
            # sample's row replaced by each candidate option
            own = (x == member_of)[None, ..., None]
            return torch.where(own, options[:, :, :, None, :], _rows(g, x))

        lpriors = ped.trio_sum(blanket, rows_of, lf_c)  # [B, n_c, H]
        counts_other = (keep[None, :, None, :] & (rows[:, :, None, :] == alleles[None, None, :, None])).sum(-1)
        cur = rows[..., k]  # [B, n_c]
        vmask = valid[:, None, :]
        if step_type == 0:
            logits = torch.where(vmask, llks + lpriors + torch.log(counts_other + 1.0), -math.inf)
            u = torch.rand(logits.shape, generator=gen, dtype=torch.float64,
                           device=device).clamp_(min=TINY)
            choice = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        else:
            ci = cur.clamp(min=0)[..., None]
            lproposal = torch.log(counts_other + 1.0) - torch.log(
                torch.gather(counts_other, -1, ci) + 1.0
            )
            ratio = (llks - torch.gather(llks, -1, ci)) + (
                lpriors - torch.gather(lpriors, -1, ci)
            ) + lproposal
            accept = torch.where(vmask, torch.exp(torch.clamp(ratio, max=0.0)), 0.0)
            n_prop = torch.clamp(nv_c - 1, min=1).double()[:, None, None]
            probs = accept.scatter(-1, ci, 0.0) / n_prop
            probs = probs.scatter(-1, ci, 1.0 - probs.sum(-1, keepdim=True))
            cdf = torch.cumsum(probs, -1)
            u = torch.rand((B, n_c, 1), generator=gen, dtype=torch.float64, device=device)
            choice = (cdf <= u * cdf[..., -1:]).sum(-1)
        new = torch.where((k < ploidy)[None, :], choice, cur)
        g[:, ids, k] = new

    def pair_swap(p, q, blanket):
        pp, pq = int(ped.ploidy[p]), int(ped.ploidy[q])
        u = torch.rand((3, B), generator=gen, dtype=torch.float64, device=device)
        idx_p = torch.clamp((u[0] * pp).long(), max=pp - 1)
        idx_q = torch.clamp((u[1] * pq).long(), max=pq - 1)
        ar = torch.arange(B, device=device)
        allele_p, allele_q = g[ar, p, idx_p], g[ar, q, idx_q]
        proposes = allele_p != allele_q

        def count(row, a, ploidy):
            return ((row[:, :ploidy] == a[:, None]).sum(-1)).double()

        gp, gq = g[:, p], g[:, q]
        proposal = count(gp, allele_p, pp) * count(gq, allele_q, pq)
        reversal = (1 + count(gp, allele_q, pp)) * (1 + count(gq, allele_p, pq))
        lproposal = torch.log(reversal) - torch.log(torch.clamp(proposal, min=1.0))
        prop = g.clone()
        prop[ar, p, idx_p] = allele_q
        prop[ar, q, idx_q] = allele_p

        def llk(state):
            return (
                _sample_llk(rh_c[:, p], cnt_c[:, p], state[:, p], pp)
                + _sample_llk(rh_c[:, q], cnt_c[:, q], state[:, q], pq)
            )

        def prior(state):
            return ped.trio_sum(blanket, lambda x: _rows(state, x), lf_c)

        log_accept = torch.clamp(
            (llk(prop) - llk(g)) + (prior(prop) - prior(g)) + lproposal, max=0.0
        )
        accept = proposes & (u[2] < torch.exp(log_accept))
        return torch.where(accept[:, None, None], prop, g)

    pair_tabs = [
        (int(p), int(q), ped.members(blanket[blanket >= 0]))
        for (p, q), blanket in zip(pairs, ped.blankets)
    ]
    for step in range(n_steps):
        for ids, blanket, ploidy in color_tabs:
            for k in range(maxp):
                slot_update(ids, blanket, ploidy, k)
        for p, q, blanket in pair_tabs:
            g = pair_swap(p, q, blanket)
        trace[:, step] = g
    return trace
