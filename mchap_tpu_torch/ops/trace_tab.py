"""Device-side posterior tabulation of packed genotype traces (PyTorch).

Port of ``mchap_tpu/ops/trace_tab.py``.  The de novo sampler emits a
base-coded genotype trace ``[n_steps, n_base, lanes]``; the posterior
summary only needs the distinct genotype states and their
multiplicities (reference ``mchap/assemble/classes.py:307-325``).  The
tabulation runs where the trace lies: canonicalise each step's
haplotype rows, lexsort the kept steps per lane, run-length encode, and
compact the distinct states to the front, so the host fetches
``O(n_unique)`` words instead of ``O(n_steps)``.

Sort keys are bit-packed big-endian into ~30-bit int32 words, which
preserves lexicographic order; multi-word keys are sorted
least-significant word first with stable sorts.  Every sort is stable,
so the head of each run of equal states carries its first occurrence.
"""

import numpy as np
import torch


def _log2(base):
    """Exact log2 of a power-of-two radix."""
    b = 0
    while (1 << b) < base:
        b += 1
    if (1 << b) != base:
        raise ValueError("packing radix must be a power of two")
    return b


def _lexsort(keys, dim):
    """Stable lexicographic sort permutation along ``dim``; ``keys[0]``
    is the most significant word."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, dim, perm)
        order = torch.sort(k, dim=dim, stable=True).indices
        perm = order if perm is None else torch.gather(perm, dim, order)
    return perm


def tabulate_packed_trace(packed, llks=None, *, ploidy, base, n_cap, burn=0):
    """Tabulate the distinct genotype states of a packed trace per lane.

    packed: int[n_steps, n_base, lanes], digit h of each value is row
    h's allele; llks: optional float[n_steps, lanes].  Returns
    ``(words, counts, first, n_unique[, state_llks])`` exactly as
    ``mchap_tpu.ops.trace_tab.tabulate_packed_trace``: words
    i32[k, n_base, lanes] with rows in canonical ascending order,
    counts and first-occurrence indices i32[k, lanes] with
    ``k = min(n_cap, kept_steps)``, n_unique i32[lanes] (a lane with
    ``n_unique > n_cap`` is incomplete), and each state's llk at its
    first occurrence.
    """
    packed = packed[burn:].to(torch.int32)
    t, nb, lanes = packed.shape
    device = packed.device
    k_out = min(n_cap, t)
    bpos = _log2(base)  # bits per allele digit
    if bpos * ploidy > 30:
        raise ValueError(
            f"packed state word needs {bpos * ploidy} bits"
            " (> 30): radix**ploidy too large for int32 tabulation"
        )

    # 1. canonical haplotype-row sort per step (position 0 most significant)
    g = torch.stack(
        [(packed // (base ** h)) % base for h in range(ploidy)], dim=1
    )  # [T, P, NB, L]
    pp_row = max(1, 30 // bpos)  # positions per row key word
    n_rw = -(-nb // pp_row)
    row_words = []
    for w in range(n_rw):
        j0 = w * pp_row
        acc = torch.zeros((t, ploidy, lanes), dtype=torch.int32, device=device)
        for i in range(min(pp_row, nb - j0)):
            acc = (acc << bpos) | g[:, :, j0 + i, :]
        row_words.append(acc)
    perm = _lexsort(row_words, dim=1)
    rs = [torch.gather(w, 1, perm) for w in row_words]

    # per-position canonical state words v_j = sum_h allele_hj * base^h
    mask = base - 1
    pos_words = []
    for j in range(nb):
        w, i = divmod(j, pp_row)
        width = min(pp_row, nb - w * pp_row)
        digits = (rs[w] >> (bpos * (width - 1 - i))) & mask  # [T, P, L]
        vj = torch.zeros((t, lanes), dtype=torch.int32, device=device)
        for h in range(ploidy):
            vj = vj + digits[:, h, :] * (base ** h)
        pos_words.append(vj)

    # 2. lexsort the kept steps per lane, dragging the step index along
    bstate = bpos * ploidy  # bits per per-position state word
    pp = max(1, 30 // bstate)
    n_kw = -(-nb // pp)
    key_words = []
    for w in range(n_kw):
        j0 = w * pp
        acc = torch.zeros((t, lanes), dtype=torch.int32, device=device)
        for i in range(min(pp, nb - j0)):
            acc = (acc << bstate) | pos_words[j0 + i]
        key_words.append(acc)
    perm = _lexsort(key_words, dim=0)  # [T, L]: sorted step indices
    kw_s = [torch.gather(k, 0, perm) for k in key_words]
    idx_s = perm.to(torch.int32)
    llk_s = torch.gather(llks[burn:], 0, perm) if llks is not None else None

    # 3. run-length encode
    kw_stack = torch.stack(kw_s, dim=1)  # [T, n_kw, L]
    head = torch.cat(
        [
            torch.ones((1, lanes), dtype=torch.bool, device=device),
            (kw_stack[1:] != kw_stack[:-1]).any(dim=1),
        ],
        dim=0,
    )  # [T, L]
    seg = torch.cumsum(head.to(torch.int32), dim=0, dtype=torch.int32) - 1
    n_unique = seg[-1] + 1  # [L]

    # 4. compact the run heads to the front with one stable sort: each
    #    head keys on its segment id, non-heads share key T
    headkey = torch.where(head, seg, torch.full_like(seg, t))
    start = torch.sort(headkey, dim=0, stable=True).indices  # run starts
    kw_c = torch.gather(kw_stack, 0, start[:, None, :].expand_as(kw_stack))[:k_out]
    first = torch.gather(idx_s, 0, start)[:k_out]
    state_llks = (
        torch.gather(llk_s, 0, start)[:k_out] if llk_s is not None else None
    )
    start = start.to(torch.int32)
    arange_t = torch.arange(t, dtype=torch.int32, device=device)[:, None]
    nxt = torch.where(
        arange_t + 1 < n_unique[None, :], torch.roll(start, -1, dims=0),
        torch.full_like(start, t),
    )
    counts = torch.where(
        arange_t < n_unique[None, :], nxt - start, torch.zeros_like(start)
    )[:k_out]

    # unpack the compacted key words back to per-position state words
    state_mask = (1 << bstate) - 1
    words = []
    for j in range(nb):
        w, i = divmod(j, pp)
        width = min(pp, nb - w * pp)
        words.append((kw_c[:, w, :] >> (bstate * (width - 1 - i))) & state_mask)
    words_c = torch.stack(words, dim=1)  # [k, NB, L]
    if state_llks is not None:
        return words_c, counts, first, n_unique, state_llks
    return words_c, counts, first, n_unique


def decode_tabulated_states(words, ploidy, base):
    """Host-side decode: words int[k, n_base, lanes] ->
    int8[k, ploidy, n_base, lanes] (digit h of a word is row h)."""
    words = np.asarray(words, np.int32)
    shifts = np.array([base ** h for h in range(ploidy)], np.int32)
    return (
        (words[:, None, :, :] // shifts[None, :, None, None]) % base
    ).astype(np.int8)
